"""The dry run's analytic half: ``repro/launch/dryrun.py`` on ``meta``.

The reference lowers and compiles every (arch x input shape x mesh) against
placeholder devices and reads XLA's artefacts.  The port builds the same
step on torch's ``meta`` device, which allocates nothing, and reports what
the shapes alone determine.  Over the reference's meshes, ``single``
(data 16, model 16) and ``multi`` (pod 2, data 16, model 16), or any
``launch.mesh.MeshShape``, that is ``per_device.argument_bytes``: the sum,
over the params, the optimizer state and the batch (the cache and tokens
in decode mode), of each leaf's local shard bytes under
``sharding.rules``, as the reference's ``_lower_and_compile`` places them;
``n_chips`` is the mesh's size and ``model_flops_per_device`` is
``model_flops / n_chips``, as in the reference.  Where the sharded train
step is held on 4 ranks (the attention, MLA, MLP and MoE sublayers:
the dense and MoE families), the step also runs once on a fake world of
``n_chips`` ranks (torch's fake process group: no devices, no
communication), its arguments ``meta`` DTensors placed by the rules, and
:class:`StepCounter` counts what one device runs: the FLOPs of its local
ops, and the bytes and calls of its collectives by op (each collective's
result, as the reference's ``collective_bytes`` reads XLA's).  Any
other combination records ``mesh_step`` with the reason.  On ``card``, one
H100, it runs the step once under
``torch.utils.flop_counter.FlopCounterMode``.  Either way: the counted
matmul FLOPs (the reference's ``hlo_flops_per_device`` counts dots; the
FFTs and the circconv kernels count nothing on either side), the exact
bytes of the step's arguments, and the three roofline terms against an
H100's peaks (the collective term over NVLink).

    # one combination, on the CPU (nothing is allocated; no card needed)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh multi --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh card --codec "c3sl:R=4"
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each result lands in ``--out`` (default ``build/dryrun`` under the
checkout), one JSON a combination.  XLA-only numbers (temp bytes, the
compiled peak, the top-k wire bytes read from HLO) have no counterpart and
are absent; the microbatch count is ``force_microbatches`` or 1 (the
reference's auto-tune loop reads XLA's memory analysis).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import codecs, transport
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.pipeline import SHAPES, input_specs
from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm as lm_lib
from repro_torch.optim import adamw
from repro_torch.sharding import rules as sh
from repro_torch.sharding.constraints import mesh_scope, microbatch

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, dense rates without
# sparsity, from NVIDIA's H100 Tensor Core GPU datasheet
H100_PEAK_FLOPS = {
    torch.bfloat16: 989e12,      # bf16 tensor cores
    "tf32": 495e12,              # float32 matmuls on the TF32 tensor cores
    torch.float32: 67e12,        # float32 outside the tensor cores
}
H100_HBM_BYTES_PER_S = 3.35e12
H100_HBM_BYTES = 80e9
H100_NVLINK_BYTES_PER_S = 900e9  # NVLink 4, all links of one card

# the dry run's meshes: one card, and the reference's production meshes
MESH_KINDS = ("card", "single", "multi")


def shape_adjusted_config(arch: str, shape_name: str) -> ModelConfig | None:
    """Per-shape config variants; None = combination skipped (the
    encoder-decoder's full-attention cross-attention at long_500k)."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        if cfg.is_encdec:
            return None
        if not cfg.attention_free:
            # the sliding-window variant makes dense/hybrid archs sub-quadratic
            cfg = dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def make_codec(cfg: ModelConfig, shape_name: str, codec_spec: str, R: int,
               quant_bits=None, unitary=False):
    """The cut-layer codec (or per-direction ``SplitLink`` from a ``... >>
    bwd:...`` spec) from a registry spec ("none" = off), and its params on
    ``meta``."""
    if codec_spec in (None, "", "none"):
        return None, None
    shape = SHAPES[shape_name]
    B = shape["global_batch"]
    if shape["kind"] == "decode":
        D = cfg.d_model
    else:
        # cut-layer feature per sample = (S_total, d_model) flattened
        D = shape["seq_len"] * cfg.d_model
    c = transport.build_link_or_codec(codec_spec, quant_bits=quant_bits,
                                      R=R, D=D, backend="fft",
                                      unitary=unitary)
    c = codecs.clamp_R(c, B if B >= 2 else 1)
    return c, c.init(device="meta")


def _peak_flops(dtype) -> float:
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        dtype = "tf32"
    return H100_PEAK_FLOPS[dtype]


def roofline_terms(flops, hbm_bytes, coll_bytes, n_chips, dtype=torch.bfloat16):
    """Three roofline terms in seconds on one H100: the FLOPs at the peak
    of ``dtype`` (a float32 matmul runs on the TF32 tensor cores only where
    ``torch.backends.cuda.matmul.allow_tf32`` is on), the bytes at the HBM
    rate, the collective bytes at the NVLink rate (the port's dry run, on
    one card, passes 0).  The numbers are per device, so ``n_chips`` is
    read by nothing: it stays for the reference's signature, which reads
    it nowhere either."""
    return {
        "compute_s": flops / _peak_flops(dtype),
        "memory_s": hbm_bytes / H100_HBM_BYTES_PER_S,
        "collective_s": coll_bytes / H100_NVLINK_BYTES_PER_S,
    }


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """6*N_active*D tokens processed (training); decode: 2*N_active per token."""
    spec = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if spec["kind"] == "train":
        tokens = spec["global_batch"] * spec["seq_len"]
        return 6.0 * n_active * tokens
    if spec["kind"] == "prefill":
        tokens = spec["global_batch"] * spec["seq_len"]
        return 2.0 * n_active * tokens
    return 2.0 * n_active * spec["global_batch"]  # one token per sequence


def make_mesh(mesh_kind):
    """The dry run's mesh: None for ``"card"`` (one H100), the reference's
    production mesh shape for ``"single"`` and ``"multi"``; a
    ``launch.mesh.MeshShape`` (any shape) passes through."""
    if not isinstance(mesh_kind, str):
        return mesh_kind
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"mesh {mesh_kind!r}: one of {MESH_KINDS} or a "
                         "launch.mesh.MeshShape")
    if mesh_kind == "card":
        return None
    return mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"))


def mesh_name(mesh_kind) -> str:
    """``mesh_kind``'s name in results: its own, or a MeshShape's sizes
    (``"4x1"`` for data 4, model 1)."""
    if isinstance(mesh_kind, str):
        return mesh_kind
    return "x".join(str(n) for n in mesh_kind.shape.values())


def np_prod_batch_shards(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def argument_specs(args, kind: str, mesh) -> tuple:
    """The rules' spec trees for ``abstract_step``'s arguments, as the
    reference's ``_lower_and_compile`` gives its ``in_shardings``: params
    by ``param_shardings`` (decode mode for decode), the AdamW state by
    ``opt_state_shardings``, the batch by ``batch_shardings``, the decode
    cache by ``cache_shardings``, the decode position replicated."""
    params = args[0]
    mode = "decode" if kind == "decode" else "train"
    param_sh = sh.param_shardings(params, mesh, mode=mode)
    if kind == "train":
        _, opt_state, batch = args
        return (param_sh, sh.opt_state_shardings(opt_state, mesh),
                sh.batch_shardings(batch, mesh))
    if kind == "prefill":
        return param_sh, sh.batch_shardings(args[1], mesh)
    _, cache, tokens, _ = args
    return (param_sh, sh.cache_shardings(cache, mesh),
            sh.batch_shardings({"tokens": tokens}, mesh)["tokens"], ())


def sharded_bytes(tree, specs, mesh) -> int:
    """The bytes of one device's shards of ``tree``'s tensors placed by
    ``specs`` (a tree of the same structure) on ``mesh``."""
    sizes = tree_map(lambda t, s: math.prod(sh.local_shape(t.shape, s, mesh))
                     * t.element_size(), tree, specs)
    return sum(tree_leaves(sizes))


def build_train_step(cfg: ModelConfig, codec=None, codec_params=None,
                     num_microbatches: int = 1):
    """Full training step: loss + grads (+ gradient accumulation) + AdamW.

    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``
    runs where its tensors are (the card, the CPU or ``meta``).
    Microbatching bounds peak activation memory: the batch is split into
    ``num_microbatches`` chunks of consecutive rows run one after another,
    their gradients summed into a float32 tree (on a mesh, each rank runs
    its share of each chunk's rows: ``sharding.constraints.microbatch``).
    From the second microbatch on, two gradient trees are held (the sum
    and the microbatch's), as in the reference's scan carry; only the
    activations shrink.  The update is
    AdamW(1e-4) in place on ``params`` and ``opt_state`` (the reference
    donates both to its compiled step; the numbers are those of
    ``apply_updates``)."""
    opt = adamw(1e-4)
    M = num_microbatches

    def train_step(params, opt_state, batch):
        with mesh_scope(params):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        train = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(train)
        acc = None
        loss = 0.0
        for m in range(M):
            mb = batch if M == 1 else tree_map(
                lambda x: microbatch(x, M, m), batch)
            lm = lm_lib.lm_loss(train, mb, cfg, codec=codec,
                                codec_params=codec_params)
            got = torch.autograd.grad(lm, leaves, allow_unused=True)
            if any(g is None for g in got):
                raise RuntimeError("a param leaf is not on the loss's graph")
            if acc is None:
                acc = [g.float() for g in got]
            else:
                for a, g in zip(acc, got):
                    a.add_(g)
            del got
            loss = loss + lm.detach()
        del train, leaves
        if M > 1:
            loss = loss / M
            for g in acc:
                g.div_(M)
        opt.update_(tree_unflatten(params, acc), opt_state, params)
        return params, opt_state, loss

    return opt, train_step


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def count_flops(fn, *args):
    """``fn(*args)`` once under ``FlopCounterMode``: (its output, the
    counted FLOPs, the FLOPs by op)."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    by_op = {str(op): int(n) for op, n in fc.get_flop_counts()["Global"].items()}
    return out, int(fc.get_total_flops()), by_op


# the collectives by the reference's names (``collective_bytes``), matched
# on the op's name: torch's functional collectives (DTensor's), their
# autograd forms, the c10d ops and DTensor's own all-to-all
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("send", "collective-permute"), ("recv", "collective-permute"),
                     ("permute", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")


def _collective(op: str):
    """The reference's name of the collective ``op`` (an op packet's
    name, ``"_c10d_functional.all_reduce"``), or None."""
    space, _, name = op.partition(".")
    if space not in _COLLECTIVE_NAMESPACES:
        return None
    return next((kind for key, kind in _COLLECTIVE_NAMES if key in name), None)


def _result_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(o) for o in out)
    return 0


class StepCounter(TorchDispatchMode):
    """What one device runs, counted on its local tensors: an op on
    DTensors is handed back (``NotImplemented``) so that DTensor runs it,
    and the local ops it runs come through here.  Counts the FLOPs of the
    matmul-class ops by op (``FlopCounterMode``'s formulas), and each
    collective's calls and result bytes under the reference's names.  The
    ops DTensor's sharding propagation runs on fake tensors (global
    shapes, no data) are not counted.  ``FlopCounterMode`` over DTensors
    counts the global shapes instead."""

    def __init__(self):
        super().__init__()
        self.flops_by_op: dict = {}
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.coll_calls = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            name = str(packet)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        kind = _collective(str(packet))
        if kind is not None:
            self.coll_bytes[kind] += _result_bytes(out)
            self.coll_calls[kind] += 1
        return out

    def counts(self) -> dict:
        return {"hlo_flops_per_device": sum(self.flops_by_op.values()),
                "flops_by_op": dict(self.flops_by_op),
                "collective_bytes_per_device": {
                    **self.coll_bytes, "total": sum(self.coll_bytes.values())},
                "collective_calls_per_device": dict(self.coll_calls)}


@contextlib.contextmanager
def fake_world(mesh):
    """``mesh`` (a ``MeshShape``) as a ``launch.mesh.HostMesh`` over a fake
    world of ``mesh.size`` ranks (``torch.testing``'s fake process group,
    this process rank 0; its collectives move nothing).  The default
    process group is destroyed on the way out, so that a real group can
    be made after it; it must not exist on the way in."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run's fake world is this process's default "
                           "process group: destroy the one that exists first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    mesh_lib.forget_mesh_caches()
    try:
        yield mesh_lib.HostMesh(init_device_mesh(
            "cpu", tuple(mesh.shape.values()),
            mesh_dim_names=tuple(mesh.axis_names)))
    finally:
        dist.destroy_process_group()


def place_meta(tree, specs, mesh):
    """Each ``meta`` tensor of ``tree`` as a DTensor on ``mesh`` (a
    ``HostMesh``) placed by its spec, from an empty local shard
    (``DTensor.from_local``: no communication)."""
    from torch.distributed.tensor import DTensor
    dm = mesh.device_mesh

    def one(t, spec):
        local = torch.empty(sh.local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, dm, sh.placements(spec, dm),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return tree_map(one, tree, specs)


def count_step(fn, *args):
    """``fn(*args)`` once under a :class:`StepCounter`: (its output, the
    counts)."""
    with StepCounter() as counter:
        out = fn(*args)
    return out, counter.counts()


# the sublayer kinds whose sharded train step a 4-rank test holds
MESH_STEP_KINDS = frozenset({"attn", "mla", "mlp", "moe"})


def mesh_step_gap(cfg: ModelConfig, kind: str):
    """Why the step of ``kind`` is not counted on a mesh for ``cfg`` (a
    dict with the reason and the ROADMAP item), or None where it is."""
    if kind != "train":
        return {"reason": f"the {kind} step over a mesh is held by no 4-rank "
                          "test (serving over a mesh)", "roadmap": "A25"}
    kinds = {k for layer in cfg.block_pattern for k in layer}
    missing = sorted(kinds - MESH_STEP_KINDS)
    if cfg.is_encdec:
        missing.append("the encoder")
    elif cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        return {"reason": f"{', '.join(missing)} over a mesh: held by no 4-rank "
                          "test", "roadmap": "A23"}
    return None


def abstract_step(cfg: ModelConfig, shape_name: str, codec, codec_params,
                  param_dtype=torch.bfloat16, num_microbatches: int = 1):
    """The step of ``shape_name``'s kind on ``meta``: (its arguments, the
    callable).  train: the train step over (params, AdamW state, batch);
    prefill: the last-token logits over (params, batch); decode: one
    ``decode_step`` over (params, cache, tokens, pos)."""
    spec = SHAPES[shape_name]
    params = lm_lib.abstract_params(cfg, param_dtype)
    # frontend embeddings in the params' dtype (the reference's default
    # bf16 equals it at the default param_dtype; torch does not promote a
    # mixed matmul)
    batch = input_specs(cfg, shape_name, param_dtype)
    if spec["kind"] == "train":
        opt, train_step = build_train_step(cfg, codec, codec_params,
                                           num_microbatches)
        args = (params, opt.init(params), batch)
        return args, train_step
    if spec["kind"] == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            # serving prefill returns the LAST-token logits (the full
            # (B, S, V) tensor is never materialized for big vocabs)
            logits, _ = lm_lib.lm_forward(params, batch, cfg, remat=False,
                                          last_only=True)
            return logits[:, -1, :]
        return (params, batch), prefill
    cache = lm_lib.abstract_decode_cache(cfg, spec["global_batch"],
                                         spec["seq_len"], param_dtype)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return lm_lib.decode_step(params, cache, tokens, pos, cfg,
                                  codec=codec, codec_params=codec_params)

    pos = torch.empty((), dtype=torch.int32, device="meta")
    return (params, cache, batch["tokens"], pos), serve_step


def dryrun_one(arch: str, shape_name: str, mesh_kind="single", *,
               codec_kind="none", R=4, quant_bits=None, unitary=False,
               save=True, tag="baseline", param_dtype=torch.bfloat16,
               cfg_override=None, force_microbatches=None, out=RESULTS_DIR,
               step=True):
    """One (arch, shape, mesh) on ``meta``.  ``shape_name`` is a key of
    ``SHAPES`` (a caller may add its own entry); ``mesh_kind`` is "card"
    (one H100: the step's counted FLOPs and roofline too), "single" or
    "multi" (the reference's meshes) or a ``launch.mesh.MeshShape``, where
    the step is counted per device on a fake world where it is held
    (:func:`mesh_step_gap`), or, with ``step=False``, not run at all (the
    argument bytes alone); ``cfg_override`` replaces the shape-adjusted
    config."""
    mesh = make_mesh(mesh_kind)
    cfg = cfg_override or shape_adjusted_config(arch, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_kind),
              "tag": tag, "codec": codec_kind, "R": R}
    if cfg is None:
        result["status"] = "skipped"
        result["reason"] = "long_500k unsupported (enc-dec full attention)"
        return _save(result, out) if save else result

    n_chips = 1 if mesh is None else mesh.size
    t0 = time.time()
    codec, codec_params = make_codec(cfg, shape_name, codec_kind, R,
                                     quant_bits, unitary)
    num_microbatches = force_microbatches or 1
    args, fn = abstract_step(cfg, shape_name, codec, codec_params,
                             param_dtype, num_microbatches)
    mf = model_flops(cfg, shape_name)
    common = {
        "status": "ok",
        "n_chips": n_chips,
        "device": "NVIDIA H100 80GB HBM3",
        "param_dtype": str(param_dtype).replace("torch.", ""),
        "num_microbatches": num_microbatches,
    }
    if mesh is not None:
        kind = SHAPES[shape_name]["kind"]
        specs = argument_specs(args, kind, mesh)
        argument_bytes = sum(sharded_bytes(a, s, mesh)
                             for a, s in zip(args, specs))
        result.update(common, **{
            "mesh_shape": dict(mesh.shape),
            "per_device": {"argument_bytes": argument_bytes},
            "fits_one_card": argument_bytes <= H100_HBM_BYTES,
            "model_flops_global": mf,
            "model_flops_per_device": mf / n_chips,
            "params_global": cfg.param_count(),
            "params_active": cfg.active_param_count(),
        })
        gap = (mesh_step_gap(cfg, kind) if step else
               {"reason": "not asked (step=False)", "roadmap": None})
        if gap is None:
            with fake_world(mesh) as world, mesh_lib.set_mesh(world):
                _, counts = count_step(fn, *(place_meta(a, s, world)
                                             for a, s in zip(args, specs)))
            result.update(_roofline_fields(
                counts, argument_bytes,
                counts["collective_bytes_per_device"]["total"], mf / n_chips,
                n_chips, param_dtype))
        else:
            result["mesh_step"] = gap
        result["trace_s"] = round(time.time() - t0, 1)
        return _save(result, out) if save else result

    argument_bytes = tree_bytes(args)
    _, flops, by_op = count_flops(fn, *args)
    result.update(common, **{
        "per_device": {"argument_bytes": argument_bytes},
        "fits_one_card": argument_bytes <= H100_HBM_BYTES,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_chips,
        **_roofline_fields({"hlo_flops_per_device": flops, "flops_by_op": by_op},
                           argument_bytes, 0, mf / n_chips, n_chips, param_dtype),
        "params_global": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "trace_s": round(time.time() - t0, 1),
    })
    return _save(result, out) if save else result


def _roofline_fields(counts, hbm_floor, coll_bytes, mf_per_device, n_chips,
                     dtype) -> dict:
    """``counts`` with the reference's roofline fields beside them: every
    argument read once is the HBM floor, the collective bytes go over
    NVLink."""
    flops = counts["hlo_flops_per_device"]
    terms = roofline_terms(flops, hbm_floor, coll_bytes, n_chips, dtype)
    return {**counts, "hbm_bytes_floor": hbm_floor,
            "useful_flops_ratio": mf_per_device / flops if flops else None,
            "roofline": terms, "dominant": max(terms, key=terms.get)}


def pipeline_dryrun(arch: str, *, R: int = 4, quant_bits=None, unitary=False,
                    num_microbatches: int = 4, shape_name: str = "train_4k",
                    tag: str = "pipeline", save: bool = True,
                    codec_kind: str = "c3sl", async_depth: int = 1,
                    cfg_override=None, out=RESULTS_DIR):
    """The 2-stage pod pipeline's wire from shapes: a step sends
    ``num_microbatches`` payloads of the forward codec's
    ``payload_shape(mb)``, ``wire_bytes(mb)`` each, over
    ``num_microbatches + async_depth`` schedule steps (the port's schedule,
    ``transport.make_pod_pipeline_loss_fn``; its ``loss.last_call`` records
    the same numbers as it runs).  ``codec_kind`` may be a ``... >>
    bwd:...`` link spec; ``cfg_override`` replaces ``arch``'s config."""
    cfg = cfg_override or get_config(arch)
    spec = SHAPES[shape_name]
    B, S = spec["global_batch"], spec["seq_len"]
    mb = B // num_microbatches
    D_flat = S * cfg.d_model

    if codec_kind == "none":
        codec = codecs.build("identity", D=D_flat)
    else:
        codec = codecs.clamp_R(
            transport.build_link_or_codec(codec_kind, quant_bits=quant_bits,
                                          R=R, D=D_flat, backend="fft",
                                          unitary=unitary), mb)
    link = isinstance(codec, transport.SplitLink)
    fwd = codec.fwd.codec if link else codec
    wire = fwd.wire_bytes(mb)
    result = {
        "arch": arch, "shape": shape_name, "mesh": "card-pipeline",
        "tag": tag, "codec": codec_kind if codec_kind != "none" else "identity",
        # links report the FORWARD channel's R (SplitLink carries no bare R)
        "R": getattr(codec.fwd.current if link else codec, "R", 1),
        "quant": quant_bits,
        "num_microbatches": num_microbatches, "async_depth": async_depth,
        "status": "ok",
        "schedule_steps": num_microbatches + async_depth,
        "payloads_per_step": num_microbatches,
        "payload_shape": list(fwd.payload_shape(mb)),
        "payload_bytes": wire,
        "payload_bytes_per_step": num_microbatches * wire,
    }
    if save:
        os.makedirs(out, exist_ok=True)
        name = f"{arch}_{shape_name}_pipeline_{tag}.json"
        with open(os.path.join(out, name), "w") as f:
            json.dump(result, f, indent=1)
    return result


def _save(result, out=RESULTS_DIR):
    os.makedirs(out, exist_ok=True)
    name = f"{result['arch']}_{result['shape']}_{result['mesh']}_{result['tag']}.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESH_KINDS), default="single")
    ap.add_argument("--codec", default="none",
                    help="registry spec, e.g. 'c3sl:R=4|int8' (see repro_torch.codecs)")
    ap.add_argument("--R", type=int, default=4)
    ap.add_argument("--quant", type=int, default=None)
    ap.add_argument("--unitary", action="store_true")
    ap.add_argument("--tag", default="baseline")
    # parsed and ignored, as the reference's main does
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory for the JSON results")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s, m) for a in ALL_ARCHS for s in SHAPES
                  for m in MESH_KINDS]
    else:
        combos = [(args.arch, args.shape, args.mesh)]

    failures = 0
    for arch, shape_name, mesh_kind in combos:
        try:
            r = dryrun_one(arch, shape_name, mesh_kind, codec_kind=args.codec,
                           R=args.R, tag=args.tag, quant_bits=args.quant,
                           unitary=args.unitary, out=args.out)
            status = r["status"]
            extra = ""
            if status == "ok":
                ab = r["per_device"]["argument_bytes"]
                extra = (f"args={ab/2**30:.2f}GiB "
                         + (f"dom={r['dominant']} " if "dominant" in r
                            else f"chips={r['n_chips']} ")
                         + f"trace={r['trace_s']}s")
            print(f"[dryrun] {arch} {shape_name} {mesh_kind}: {status} {extra}",
                  flush=True)
        except Exception:
            failures += 1
            print(f"[dryrun] {arch} {shape_name} {mesh_kind}: FAILED", flush=True)
            traceback.print_exc()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
