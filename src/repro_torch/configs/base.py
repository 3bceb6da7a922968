"""Model/architecture config dataclass + registry.

Port of ``repro/configs/base.py`` (pure data, kept as its own copy: the
port imports nothing of ``repro``).

A config fully describes one architecture.  The repeating unit of the layer
stack is `block_pattern`: a tuple of layers, each layer a tuple of sublayer
kinds, e.g.

    dense:   ((("attn", "mlp"),))                      x num_layers
    moe:     ((("attn", "moe"),))                      x num_layers
    jamba:   1 attn + 7 mamba layers, MoE every 2nd    x (num_layers / 8)
    rwkv:    ((("rwkv_tm", "rwkv_cm"),))               x num_layers
    enc-dec: decoder layers are ("attn","cross","mlp")

`num_layers` must divide evenly into superblocks of len(block_pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

SUBLAYER_KINDS = ("attn", "mla", "mlp", "moe", "mamba", "rwkv_tm", "rwkv_cm", "cross")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int                   # decoder/backbone depth (per stack)
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None       # default d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0       # fraction of head_dim rotated ("2d RoPE" = 0.5)
    block_pattern: tuple = ((("attn", "mlp")),)
    norm: str = "rmsnorm"
    gated_mlp: bool = True
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0       # leading layers use dense MLP instead of MoE
    capacity_factor: float = 1.25     # train-time expert capacity (decode never drops)
    aux_loss_weight: float = 0.01
    # --- SSM ---
    d_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    rwkv_mode: str = "chunked"        # "chunked" (matmul form) | "sequential"
    # --- encoder-decoder ---
    encoder_layers: int = 0           # > 0 => enc-dec; encoder is ("attn","mlp")
    # --- modality frontend stub ---
    frontend: str | None = None       # "vision" | "audio"
    frontend_dim: int = 0             # raw patch/frame embedding dim
    frontend_seq: int = 0             # patches/frames per sample
    # --- attention variants ---
    sliding_window: int | None = None
    kv_cache_quant: bool = False      # int8 KV cache (beyond-paper, serving)
    # --- citation ---
    source: str = ""

    def __post_init__(self):
        object.__setattr__(self, "block_pattern",
                           tuple(tuple(l) for l in self.block_pattern))
        for layer in self.block_pattern:
            for k in layer:
                assert k in SUBLAYER_KINDS, k
        pat = len(self.block_pattern)
        assert (self.num_layers - self.first_dense_layers) % pat == 0, \
            (self.name, self.num_layers, pat)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def rotary_dim(self) -> int:
        rd = int(self.head_dim_ * self.partial_rotary)
        return rd - rd % 2

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def num_superblocks(self) -> int:
        return (self.num_layers - self.first_dense_layers) // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        kinds = {k for l in self.block_pattern for k in l}
        return not (kinds & {"attn", "mla", "cross"})

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid always; attention archs only with
        a sliding window (enc-dec excluded, see DESIGN.md)."""
        if self.is_encdec:
            return False
        return True  # dense archs run long_500k via the sliding-window variant

    def param_count(self) -> int:
        """Total parameters (analytic)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim_
        n = 0

        def attn_params():
            return d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d

        def mla_params():
            return (d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * self.kv_lora_rank
                    + self.kv_lora_rank * self.num_heads * self.qk_nope_dim
                    + self.kv_lora_rank * self.num_heads * self.v_head_dim
                    + d * self.qk_rope_dim
                    + self.num_heads * self.v_head_dim * d)

        def mlp_params(f=None):
            f = f or ff
            return d * f * (3 if self.gated_mlp else 2)

        def moe_params():
            f = self.moe_d_ff or ff
            shared = mlp_params(f * self.num_shared_experts) if self.num_shared_experts else 0
            return d * self.num_experts + self.num_experts * 3 * d * f + shared

        def mamba_params():
            di = self.d_inner
            dtr = max(d // 16, 1)
            return (d * 2 * di + self.d_conv * di + di * (dtr + 2 * self.d_state)
                    + dtr * di + di * self.d_state + di * d)

        def rwkv_tm_params():
            return 5 * d * d + 2 * d * 64  # 5 projections + decay lora

        def rwkv_cm_params():
            return 2 * d * ff + d * d  # w_k (d,ff) + w_v (ff,d) + w_r (d,d)

        per_kind = {"attn": attn_params, "mla": mla_params, "mlp": mlp_params,
                    "moe": moe_params, "mamba": mamba_params,
                    "rwkv_tm": rwkv_tm_params, "rwkv_cm": rwkv_cm_params,
                    "cross": attn_params}
        for layer in self.block_pattern:
            for k in layer:
                n += per_kind[k]()
        n *= self.num_superblocks
        n += self.first_dense_layers * (
            (mla_params() if "mla" in self.block_pattern[0] else attn_params())
            + mlp_params())
        n += V * d * 2  # embed + head
        if self.is_encdec:
            n += self.encoder_layers * (attn_params() + mlp_params())
        if self.frontend:
            n += self.frontend_dim * d
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        f = self.moe_d_ff or self.d_ff
        moe_layers = sum(1 for l in self.block_pattern for k in l if k == "moe")
        moe_layers *= self.num_superblocks
        inactive = moe_layers * (self.num_experts - self.experts_per_token) * 3 * self.d_model * f
        return full - inactive


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch.configs import archs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    from repro_torch.configs import archs  # noqa: F401
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test variant of the same family: 2 superblocks, tiny dims."""
    pat = len(cfg.block_pattern)
    small = dict(
        num_layers=2 * pat + cfg.first_dense_layers if cfg.first_dense_layers else 2 * pat,
        d_model=256,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=128 if cfg.moe_d_ff else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_dim=128 if cfg.frontend else 0,
        frontend_seq=8 if cfg.frontend else 0,
        sliding_window=None,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
