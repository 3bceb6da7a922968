"""RWKV-6 ("Finch") block: time-mix with data-dependent decay, and
channel-mix; the training forward and the O(1) decode step.

Port of ``repro/models/rwkv.py``.  Recurrence per
head (k-dim x v-dim outer-product state S):
    y_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
with w_t = exp(-exp(w0 + tanh(x_w A) B)).

``apply_rwkv_timemix`` has the reference's two modes: ``"sequential"``
(one state update a step, each chunk recomputed in the backward) and
``"chunked"`` (intra-chunk masked matmuls plus an inter-chunk state scan),
with the reference's midpoint-centred log-decay factorisation, which keeps
every exponent of the intra-chunk factors within half a chunk's decay and
so keeps float32 safe.  The reference's sharding constraint on the scanned
state has no counterpart on one card.

Decode keeps the reference's state: the float32 wkv matrix (B, H, hd, hd)
and the token-shift inputs ``x_prev_tm`` / ``x_prev_cm`` (B, D), and
advances it one token a call through the same ``_wkv_step``.  Mixed
products promote as JAX does (``layers.matmul``): a float32 token-shift
state under bfloat16 weights computes in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import _normal, dense_init, matmul


def init_rwkv_timemix(rng: torch.Generator, d_model: int, num_heads: int, *,
                      decay_lora: int = 64, dtype=torch.float32, lead: tuple = ()):
    hd = d_model // num_heads
    dev = rng.device

    def full(v):
        return torch.full((*lead, d_model), v, dtype=dtype, device=dev)

    p = {m: full(0.5) for m in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g")}
    for w in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[w] = dense_init(rng, d_model, d_model, dtype, lead=lead)
    p.update({
        "w0": full(-0.6),
        "w_dec_a": dense_init(rng, d_model, decay_lora, dtype, lead=lead),
        "w_dec_b": _normal(rng, (*lead, decay_lora, d_model), 0.01, dtype),
        "u": _normal(rng, (*lead, num_heads, hd), 0.1, dtype),
        "ln_scale": full(1.0),
    })
    return p


def _shift(x):
    """Token shift: x_{t-1} with zeros at t=0.  x (B,S,D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _timemix_inputs(p, x, num_heads: int):
    B, S, D = x.shape
    hd = D // num_heads
    xp = _shift(x)

    def mix(m):
        return x + p[m] * (xp - x)

    r = (mix("mix_r") @ p["w_r"]).reshape(B, S, num_heads, hd)
    k = (mix("mix_k") @ p["w_k"]).reshape(B, S, num_heads, hd)
    v = (mix("mix_v") @ p["w_v"]).reshape(B, S, num_heads, hd)
    g = F.silu(mix("mix_g") @ p["w_g"])
    dec = p["w0"] + torch.tanh(mix("mix_w") @ p["w_dec_a"]) @ p["w_dec_b"]
    w = torch.exp(-torch.exp(dec.float())).reshape(B, S, num_heads, hd)
    return r, k, v, g, w


def _wkv_step(S_state, inputs, u):
    """S (B,H,hd,hd); r,k,v,w (B,H,hd)."""
    r, k, v, w = inputs
    kv = k[..., :, None] * v[..., None, :]                       # (B,H,hdk,hdv)
    y = torch.einsum("bhk,bhkv->bhv", r, S_state + u[..., :, None] * kv)
    S_new = w[..., :, None] * S_state + kv
    return S_new, y


def _groupnorm_gate_out(p, y, g, x_dtype, B, S, num_heads, hd):
    D = num_heads * hd
    y = y.reshape(B, S, num_heads, hd)
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, D)
    y = y.to(x_dtype) * p["ln_scale"]
    return (y * g) @ p["w_o"]


def _sequential_chunk(S0, rs, ks, vs, ws, u):
    """One chunk of the per-step recurrence: inputs (chunk, B, H, hd)."""
    ys = []
    for t in range(rs.shape[0]):
        S0, y = _wkv_step(S0, (rs[t], ks[t], vs[t], ws[t]), u)
        ys.append(y)
    return S0, torch.stack(ys)


def _inter_chunk(S0, r_in_c, k_out_c, v_c, decay_c):
    """One chunk of the state scan: S0 (B,H,hd_k,hd_v); decay along hd_k."""
    y_int = torch.einsum("bthd,bhde->bthe", r_in_c, S0)
    S_new = S0 * decay_c[..., None] + torch.einsum("bshd,bshe->bhde", k_out_c, v_c)
    return S_new, y_int


def _scan(fn, S0, xs):
    """The reference's ``lax.scan(jax.checkpoint(fn), S0, xs)``: ``fn`` over
    the leading axis of every tensor in ``xs``, each call recomputed in the
    backward; returns the stacked per-call outputs."""
    ys = []
    for i in range(xs[0].shape[0]):
        args = (S0, *(t[i] for t in xs))
        if torch.is_grad_enabled():
            S0, y = checkpoint(fn, *args, use_reentrant=False)
        else:
            S0, y = fn(*args)
        ys.append(y)
    return torch.stack(ys)


def apply_rwkv_timemix(p, x: torch.Tensor, *, num_heads: int, chunk: int = 64,
                       mode: str = "chunked") -> torch.Tensor:
    """RWKV-6 time-mix, ``mode`` "chunked" (the matmul form) or
    "sequential" (the per-step recurrence): the same math."""
    B, S, D = x.shape
    hd = D // num_heads
    r, k, v, g, w = _timemix_inputs(p, x, num_heads)
    u = p["u"].float()

    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    n_chunks = S // chunk
    S0 = torch.zeros((B, num_heads, hd, hd), dtype=torch.float32, device=x.device)

    if mode == "sequential":
        def reshape_c(t):  # (B,S,H,hd) -> (n_chunks, chunk, B, H, hd)
            return t.float().reshape(B, n_chunks, chunk, num_heads, hd) \
                .permute(1, 2, 0, 3, 4)

        ys = _scan(lambda S0, *xs: _sequential_chunk(S0, *xs, u), S0,
                   [reshape_c(t) for t in (r, k, v, w)])
        y = ys.reshape(n_chunks * chunk, B, num_heads, hd).permute(1, 0, 2, 3)
        return _groupnorm_gate_out(p, y, g, x.dtype, B, S, num_heads, hd)

    # ---- chunked matmul form ----------------------------------------------
    C = chunk

    def reshape_n(t):  # (B,S,H,hd) -> (n, B, C, H, hd)
        return t.reshape(B, n_chunks, C, num_heads, hd).permute(1, 0, 2, 3, 4) \
            .float()

    rn, kn, vn, wn = map(reshape_n, (r, k, v, w))
    lw = torch.log(torch.clamp(wn, min=1e-38))         # (n,B,C,H,hd), <= 0
    c = torch.cumsum(lw, dim=2)                        # within-chunk log decay

    # y_t reads S_{t-1}: the contribution of s < t decays by w_{s+1}..w_{t-1},
    # exp(c_{t-1} - c_s): the shifted cumsum on the query side
    c_prev = F.pad(c[:, :, :-1], (0, 0, 0, 0, 1, 0))
    # midpoint centring keeps both factors' exponents <= half-chunk decay
    c_mid = c[:, :, C // 2:C // 2 + 1]
    r_tilde = rn * torch.exp(c_prev - c_mid)
    k_tilde = kn * torch.exp(c_mid - c)
    c_end = c[:, :, -1:]

    # intra-chunk scores A[t,s] = sum_d r_t k_s exp(c_{t-1} - c_s), s < t
    A = torch.einsum("nbthd,nbshd->nbhts", r_tilde, k_tilde)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device),
                     diagonal=-1)
    A = torch.where(tri, A, torch.zeros((), dtype=A.dtype, device=A.device))
    # the current token's bonus diagonal: r_t . (u * k_t)
    diag = torch.einsum("nbthd,hd,nbthd->nbth", rn, u, kn)
    y_intra = torch.einsum("nbhts,nbshd->nbthd", A, vn) + diag[..., None] * vn

    # inter-chunk: y_t += (r_t exp(c_{t-1})) @ S_chunk_start; the state:
    # S' = exp(c_end) S + sum_s k_s exp(c_end - c_s) (x) v_s (all <= 1)
    r_in = rn * torch.exp(c_prev)
    k_out = kn * torch.exp(c_end - c)
    decay_end = torch.exp(c_end[:, :, 0])              # (n,B,H,hd_k)
    y_inter = _scan(_inter_chunk, S0, [r_in, k_out, vn, decay_end])

    y = (y_intra + y_inter).permute(1, 0, 2, 3, 4).reshape(B, S, num_heads, hd)
    return _groupnorm_gate_out(p, y, g, x.dtype, B, S, num_heads, hd)


def init_rwkv_channelmix(rng: torch.Generator, d_model: int, d_ff: int,
                         dtype=torch.float32, *, lead: tuple = ()):
    dev = rng.device
    return {
        "mix_k": torch.full((*lead, d_model), 0.5, dtype=dtype, device=dev),
        "mix_r": torch.full((*lead, d_model), 0.5, dtype=dtype, device=dev),
        "w_k": dense_init(rng, d_model, d_ff, dtype, lead=lead),
        "w_v": dense_init(rng, d_ff, d_model, dtype, lead=lead),
        "w_r": dense_init(rng, d_model, d_model, dtype, lead=lead),
    }


def apply_rwkv_channelmix(p, x: torch.Tensor) -> torch.Tensor:
    xp = _shift(x)
    xk = x + p["mix_k"] * (xp - x)
    xr = x + p["mix_r"] * (xp - x)
    k = torch.square(F.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"])


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------

def init_rwkv_state(batch: int, d_model: int, num_heads: int,
                    dtype=torch.float32, *, device="cuda"):
    hd = d_model // num_heads
    return {
        "wkv": torch.zeros((batch, num_heads, hd, hd), dtype=torch.float32,
                           device=device),
        "x_prev_tm": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "x_prev_cm": torch.zeros((batch, d_model), dtype=dtype, device=device),
    }


def apply_rwkv_timemix_decode(p, x, state, *, num_heads: int):
    """x (B,1,D) one token; ``state`` carries the token shift and wkv.
    Returns (y (B,1,D), new state); ``state`` is read, not written."""
    B, _, D = x.shape
    hd = D // num_heads
    xt = x[:, 0]
    xp = state["x_prev_tm"]

    def mix(m):
        return xt + p[m] * (xp - xt)

    r = matmul(mix("mix_r"), p["w_r"]).reshape(B, num_heads, hd).float()
    k = matmul(mix("mix_k"), p["w_k"]).reshape(B, num_heads, hd).float()
    v = matmul(mix("mix_v"), p["w_v"]).reshape(B, num_heads, hd).float()
    g = F.silu(matmul(mix("mix_g"), p["w_g"]))
    dec = p["w0"] + matmul(torch.tanh(matmul(mix("mix_w"), p["w_dec_a"])),
                           p["w_dec_b"])
    w = torch.exp(-torch.exp(dec.float())).reshape(B, num_heads, hd)
    S_new, y = _wkv_step(state["wkv"], (r, k, v, w), p["u"].float())
    # the per-head norm: jnp.var is the biased variance
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, D).to(x.dtype) * p["ln_scale"]
    out = matmul(y * g, p["w_o"])
    return out[:, None, :], dict(state, wkv=S_new, x_prev_tm=xt)


def apply_rwkv_channelmix_decode(p, x, state):
    xt = x[:, 0]
    xp = state["x_prev_cm"]
    xk = xt + p["mix_k"] * (xp - xt)
    xr = xt + p["mix_r"] * (xp - xt)
    k = torch.square(F.relu(matmul(xk, p["w_k"])))
    out = torch.sigmoid(matmul(xr, p["w_r"])) * matmul(k, p["w_v"])
    return out[:, None, :], dict(state, x_prev_cm=xt)
