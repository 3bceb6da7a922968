"""The port's dry run (``repro_torch.launch.dryrun``, ``data.pipeline``'s
``SHAPES`` and ``input_specs``, ``lm.abstract_params`` and
``abstract_decode_cache``) held against the JAX reference, and its meta
counts against the same step on real CPU tensors.

The analytic numbers must equal the reference's exactly: the shapes, the
shape-adjusted configs and ``model_flops`` for all ten archs at the four
shapes, the batch specs (tokens and labels int64 where the reference's are
int32), the abstract params' key paths, shapes and dtypes against
``jax.eval_shape`` (every arch reduced, deepseek-7b and jamba-1.5-large-398b
at full width, where an allocating init would need 27.6 GB and 1.6 TB), the
abstract decode caches, the codec's spec, R, D, payload shape and wire
bytes.  Port against port: the FLOPs that ``FlopCounterMode`` counts on
``meta`` equal the count of the same step on CPU tensors, and the argument
bytes the real tensors' bytes, for a dense, an MoE and a Mamba + MoE arch.
``build_train_step`` is held to the reference's (loss and every updated
param), ``pipeline_dryrun`` to the record of a real pipeline call, and
the CLI runs in a subprocess."""
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import transport as jtransport  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import codecs as tcodecs  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.configs.archs import ALL_ARCHS  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.transport import make_pod_pipeline_loss_fn  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DTYPES = {"int32": torch.int64, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "int8": torch.int8}
# float32 on both sides; XLA:CPU and PyTorch sum in other orders: the loss
# to a few ulps, the gradients (AdamW's first moment, 0.1 g) and their
# squares (the second moment) within a few 1e-6 of each leaf's max (the
# LM training tests' GRAD_TOL).  AdamW's first step moves a param by lr * g
# / (|g| + 1e-8): where |g| is near that eps, a rounding of g moves the step
# by a share of lr (measured: at most 0.095 lr, at |g| 8e-9)
LOSS_TOL = 1e-6          # |loss difference| / |loss|
GRAD_TOL = 2e-5          # max |moment difference| / max |moment|, per leaf
STEP_TOL = 0.2 * 1e-4    # max |param difference| after the step, absolute
SMALL = {"tiny_train": dict(seq_len=16, global_batch=8, kind="train"),
         "tiny_decode": dict(seq_len=32, global_batch=4, kind="decode")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several xdist workers; torch's intra-op threads
    would oversubscribe the cores, so this module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_shapes(monkeypatch):
    """Small entries added to both packages' SHAPES (one dict object each,
    read by every dry-run function)."""
    for name, spec in SMALL.items():
        monkeypatch.setitem(tpipeline.SHAPES, name, spec)
        monkeypatch.setitem(jpipeline.SHAPES, name, spec)


def _jdryrun():
    """The reference's dry-run module.  It sets XLA_FLAGS for 512 host
    devices when imported; the backend is brought up first (so the flag
    cannot take effect here) and the variable is restored."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdryrun


def _spec_tree(tree, prefix=""):
    """{key path: (shape, dtype name)} of a reference ShapeDtypeStruct tree
    or a port tensor tree (the port's dtype names mapped to the reference's
    for comparison: int64 tokens count as int32)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_spec_tree(v, path))
        elif isinstance(v, torch.Tensor):
            out[path] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        else:
            out[path] = (tuple(v.shape), str(v.dtype))
    return out


def _port_view(spec):
    return {k: (s, DTYPES[d]) for k, (s, d) in spec.items()}


def _torch_dtypes(spec):
    return {k: (s, getattr(torch, d)) for k, (s, d) in spec.items()}


def test_shapes_equal_the_reference():
    assert tpipeline.SHAPES == jpipeline.SHAPES
    assert dryrun.SHAPES is tpipeline.SHAPES


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shape_adjusted_config_and_model_flops(arch):
    jd = _jdryrun()
    for shape in tpipeline.SHAPES:
        tc = dryrun.shape_adjusted_config(arch, shape)
        jc = jd.shape_adjusted_config(arch, shape)
        if jc is None:
            assert tc is None
            continue
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dryrun.model_flops(tc, shape) == jd.model_flops(jc, shape)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in tpipeline.SHAPES:
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            want = _port_view(_spec_tree(jpipeline.input_specs(jcfg, shape, jdt)))
            got = tpipeline.input_specs(tcfg, shape, tdt)
            assert all(t.device.type == "meta" for t in got.values())
            assert _torch_dtypes(_spec_tree(got)) == want, (arch, shape)


def _abstract_pair(arch, full):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if not full:
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    return jcfg, tcfg


@pytest.mark.parametrize("arch,full", [(a, False) for a in ALL_ARCHS]
                         + [("deepseek-7b", True),
                            ("jamba-1.5-large-398b", True)])
def test_abstract_params(arch, full):
    jcfg, tcfg = _abstract_pair(arch, full)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = _port_view(_spec_tree(jlm.abstract_params(jcfg, jdt)))
        got = tlm.abstract_params(tcfg, tdt)
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert _torch_dtypes(_spec_tree(got)) == want


@pytest.mark.parametrize("arch,quant", [(a, False) for a in ALL_ARCHS]
                         + [("deepseek-7b", True)])
def test_abstract_decode_cache(arch, quant):
    jcfg, tcfg = _abstract_pair(arch, False)
    if quant:   # int8 KV with float32 scales
        jcfg = dataclasses.replace(jcfg, kv_cache_quant=True)
        tcfg = dataclasses.replace(tcfg, kv_cache_quant=True)
    want = _port_view(_spec_tree(jlm.abstract_decode_cache(jcfg, 4, 64)))
    got = tlm.abstract_decode_cache(tcfg, 4, 64)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _torch_dtypes(_spec_tree(got)) == want


def test_real_init_unchanged_by_the_meta_path():
    """The seeded draws of ``init_lm_params`` are those of a fresh
    generator, whatever ran on meta before (bitwise)."""
    cfg = tconfigs.reduced(tconfigs.get_config("jamba-1.5-large-398b"))
    a = tlm.init_lm_params(3, cfg, device="cpu")
    tlm.abstract_params(cfg)
    b = tlm.init_lm_params(3, cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("spec", ["c3sl:R=4", "c3sl:R=4 >> bwd:c3sl:R=2"])
def test_make_codec(spec):
    jd = _jdryrun()
    for shape in ("train_4k", "decode_32k", "long_500k"):
        jc, _ = jd.make_codec(jconfigs.get_config("deepseek-7b"), shape, spec, 8)
        tc, tp = dryrun.make_codec(tconfigs.get_config("deepseek-7b"), shape,
                                   spec, 8)
        assert tc.spec() == jc.spec()
        assert all(t.device.type == "meta" for t in tree_leaves(tp))
        B = tpipeline.SHAPES[shape]["global_batch"]
        if isinstance(jc, jtransport.SplitLink):
            assert tc.wire_bytes_fwd(B) == jc.wire_bytes_fwd(B)
            assert tc.wire_bytes_bwd(B) == jc.wire_bytes_bwd(B)
            jc, tc = jc.fwd.codec, tc.fwd.codec
        assert (tc.R, tc.D) == (jc.R, jc.D)
        assert tc.payload_shape(B) == jc.payload_shape(B)
        assert tc.wire_bytes(B) == jc.wire_bytes(B)
    assert dryrun.make_codec(tconfigs.get_config("deepseek-7b"), "train_4k",
                             "none", 4) == (None, None)


def _real_args(cfg, shape, param_dtype):
    """The real CPU tensors of ``dryrun.abstract_step``'s arguments."""
    spec = tpipeline.SHAPES[shape]
    B, S = spec["global_batch"], spec["seq_len"]
    params = tlm.init_lm_params(0, cfg, param_dtype, device="cpu")
    rng = np.random.default_rng(1)
    if spec["kind"] == "decode":
        cache = tlm.init_decode_cache(params, cfg, B, S, param_dtype)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
        return params, cache, tokens, torch.tensor(S // 2, dtype=torch.int32)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    return params, dryrun.adamw(1e-4).init(params), batch


@pytest.mark.parametrize("arch,shape,M", [
    ("deepseek-7b", "tiny_train", 1),
    ("deepseek-7b", "tiny_train", 2),
    ("phi3.5-moe-42b-a6.6b", "tiny_train", 1),
    ("jamba-1.5-large-398b", "tiny_train", 1),
    ("deepseek-7b", "tiny_decode", 1),
])
def test_meta_count_equals_a_real_step(small_shapes, arch, shape, M):
    """The dry run's counted FLOPs and argument bytes on meta against the
    same step run on real CPU tensors (codec c3sl:R=4 at the midpoint)."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    r = dryrun.dryrun_one(arch, shape, "card", codec_kind="c3sl:R=4", save=False,
                          cfg_override=cfg, param_dtype=torch.float32,
                          force_microbatches=M if M > 1 else None)
    codec, _ = dryrun.make_codec(cfg, shape, "c3sl:R=4", 4)
    _, fn = dryrun.abstract_step(cfg, shape, codec, codec.init(device="cpu"),
                                 torch.float32, M)
    real = _real_args(cfg, shape, torch.float32)
    assert dryrun.tree_bytes(real) == r["per_device"]["argument_bytes"]
    _, flops, by_op = dryrun.count_flops(fn, *real)
    assert (flops, by_op) == (r["hlo_flops_per_device"], r["flops_by_op"])
    assert flops > 0 and r["num_microbatches"] == M


def test_dryrun_one_record(small_shapes):
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    r = dryrun.dryrun_one("deepseek-7b", "tiny_train", "card",
                          codec_kind="c3sl:R=4", save=False, cfg_override=cfg,
                          param_dtype=torch.float32)
    mf = dryrun.model_flops(cfg, "tiny_train")
    assert r["model_flops_global"] == r["model_flops_per_device"] == mf
    assert r["useful_flops_ratio"] == mf / r["hlo_flops_per_device"]
    assert r["hbm_bytes_floor"] == r["per_device"]["argument_bytes"]
    assert r["roofline"] == {
        "compute_s": r["hlo_flops_per_device"] / 67e12,
        "memory_s": r["hbm_bytes_floor"] / 3.35e12, "collective_s": 0.0}
    assert r["dominant"] == max(r["roofline"], key=r["roofline"].get)
    assert r["fits_one_card"] and r["params_global"] == cfg.param_count()
    for absent in ("temp_bytes", "peak_bytes", "collective_bytes_per_device",
                   "topk_wire_bytes_hlo"):
        assert absent not in r and absent not in r["per_device"]
    assert r["mesh"] == "card" and r["n_chips"] == 1
    with pytest.raises(ValueError, match="mesh 'pod'"):
        dryrun.dryrun_one("deepseek-7b", "tiny_train", "pod", save=False)
    skipped = dryrun.dryrun_one("seamless-m4t-large-v2", "long_500k", "card",
                                save=False)
    assert skipped["status"] == "skipped"


def test_roofline_peaks():
    assert dryrun.roofline_terms(989e12, 3.35e12, 0, 1, torch.bfloat16) == {
        "compute_s": 1.0, "memory_s": 1.0, "collective_s": 0.0}
    assert dryrun.roofline_terms(67e12, 0, 0, 1, torch.float32)["compute_s"] == 1.0
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert dryrun.roofline_terms(495e12, 0, 0, 1,
                                     torch.float32)["compute_s"] == 1.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("M", [1, 2])
def test_build_train_step_against_the_reference(M):
    """One step from the same weights, keys and batch: the loss and every
    updated param (reduced deepseek-7b, B 4, S 8, c3sl:R=2 at the cut)."""
    jd = _jdryrun()
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    B, S = 4, 8
    pj = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    labels = rng.integers(0, jcfg.vocab_size, (B, S))
    jc = jtransport.build_link_or_codec("c3sl:R=2", D=S * jcfg.d_model)
    jcp = jc.init(jax.random.PRNGKey(7))
    tc = tcodecs.build("c3sl:R=2", D=S * tcfg.d_model)
    tcp = {"keys": torch.from_numpy(np.array(jcp["keys"]))}
    tcp["keys_fft"] = torch.fft.rfft(tcp["keys"], dim=-1)

    opt_j, step_j = jd.build_train_step(jcfg, jc, jcp, num_microbatches=M)
    jparams = jax.tree.map(jnp.asarray, pj)
    pj2, sj2, lj = jax.jit(step_j)(jparams, opt_j.init(jparams),
                                   {"tokens": jnp.asarray(toks, jnp.int32),
                                    "labels": jnp.asarray(labels, jnp.int32)})
    opt_t, step_t = dryrun.build_train_step(tcfg, tc, tcp, num_microbatches=M)
    tparams = params_from_numpy(pj, device="cpu")
    pt2, st2, lt = step_t(tparams, opt_t.init(tparams),
                          {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(labels)})
    assert abs(float(lt) - float(lj)) <= LOSS_TOL * abs(float(lj))
    assert int(st2["count"]) == int(sj2["count"]) == 1
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(st2[k]), jax.tree.leaves(sj2[k])):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= GRAD_TOL * np.abs(b).max()
    for a, b in zip(tree_leaves(pt2), jax.tree.leaves(pj2)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= STEP_TOL


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_dryrun_equals_the_call_record(small_shapes, depth):
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    M = 2
    r = dryrun.pipeline_dryrun("deepseek-7b", R=2, num_microbatches=M,
                               shape_name="tiny_train", save=False,
                               codec_kind="c3sl:R=2", async_depth=depth,
                               cfg_override=cfg)
    spec = tpipeline.SHAPES["tiny_train"]
    B, S = spec["global_batch"], spec["seq_len"]
    codec, cp = ttrain.make_codec("c3sl:R=2", S * cfg.d_model, max_R=B // M,
                                  device="cpu")
    full = tlm.init_lm_params(0, cfg, device="cpu")
    params = ttrain.pipeline_params(full, cp)
    loss_fn = make_pod_pipeline_loss_fn(*tlm.make_pipeline_fns(cfg), codec,
                                        num_microbatches=M, async_depth=depth)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                                (B, S)))
    with torch.no_grad():
        loss_fn(params, {"x": toks, "y": toks})
    rec = loss_fn.last_call
    assert (rec.payloads, rec.payload_bytes, rec.steps) == (
        r["payloads_per_step"], r["payload_bytes_per_step"], r["schedule_steps"])
    assert r["payload_shape"] == [B // M // 2, S * cfg.d_model]


def test_cli_writes_only_under_out(tmp_path):
    bench = os.path.join(ROOT, "benchmarks")
    before = sorted(os.walk(bench)) if os.path.isdir(bench) else None
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-7b", "--shape", "train_4k", "--mesh", "card", "--out",
         str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    assert re.fullmatch(r"\[dryrun\] deepseek-7b train_4k card: ok "
                        r"args=\S+GiB dom=compute_s trace=\S+s\n", run.stdout)
    files = os.listdir(tmp_path)
    assert files == ["deepseek-7b_train_4k_card_baseline.json"]
    r = json.loads((tmp_path / files[0]).read_text())
    assert r["model_flops_global"] == 6.0 * r["params_active"] * 256 * 4096
    # bf16 params, float32 moments, the int32 count, int64 tokens and labels
    n = sum(t.numel() for t in tree_leaves(
        tlm.abstract_params(tconfigs.get_config("deepseek-7b"))))
    ab = r["per_device"]["argument_bytes"]
    assert ab == 10 * n + 4 + 2 * 256 * 4096 * 8
    assert r["fits_one_card"] == (ab <= 80e9)
    after = sorted(os.walk(bench)) if os.path.isdir(bench) else None
    assert before == after
    # the reference's multi-pod mesh, per device; --pipeline is parsed and
    # ignored, as the reference's main does
    multi = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-7b", "--shape", "decode_32k", "--mesh", "multi",
         "--pipeline", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120)
    assert multi.returncode == 0, multi.stderr[-3000:]
    assert re.fullmatch(r"\[dryrun\] deepseek-7b decode_32k multi: ok "
                        r"args=\S+GiB chips=512 trace=\S+s\n", multi.stdout)
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 1
    assert bad.stdout.startswith("[dryrun] no-such-arch decode_32k single: FAILED")
    assert "no-such-arch" in bad.stderr
    assert sorted(os.listdir(tmp_path)) == sorted(
        files + ["deepseek-7b_decode_32k_multi_baseline.json"])


# --------------------------------------------------------------------------
# the mesh half: per-device argument bytes from the rules
# --------------------------------------------------------------------------

def _reference_shard_bytes(arch, shape, mesh_kind):
    """The per-device bytes the reference's specs imply for its
    ``_lower_and_compile`` arguments: each leaf's shard shape from its
    ``PartitionSpec`` on an ``AbstractMesh`` of the mesh's shape, times the
    leaf's bytes an element.  The port's tokens and labels are int64 where
    the reference's are int32 (``data.pipeline.input_specs``), so integer
    batch leaves count 8 bytes an element here, as the port's do."""
    from jax.sharding import AbstractMesh
    from repro.optim import adamw as jadamw
    from repro.sharding import rules as jrules
    multi = mesh_kind == "multi"
    mesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                        ("pod", "data", "model") if multi else ("data", "model"))
    cfg = jconfigs.get_config(arch)
    spec = jpipeline.SHAPES[shape]
    params = jax.eval_shape(lambda: jlm.init_lm_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
                          params)
    batch = jpipeline.input_specs(cfg, shape)
    kind = spec["kind"]
    trees = [(params, jrules.param_shardings(
        params, mesh, mode="decode" if kind == "decode" else "train"))]
    if kind == "train":
        opt = jax.eval_shape(jadamw(1e-4).init, params)
        trees += [(opt, jrules.opt_state_shardings(opt, mesh)),
                  (batch, jrules.batch_shardings(batch, mesh))]
    elif kind == "prefill":
        trees += [(batch, jrules.batch_shardings(batch, mesh))]
    else:
        cache = jlm.abstract_decode_cache(cfg, spec["global_batch"],
                                          spec["seq_len"], jnp.bfloat16)
        trees += [(cache, jrules.cache_shardings(cache, mesh)),
                  (batch, jrules.batch_shardings(batch, mesh))]
    total = 4 if kind == "decode" else 0        # the replicated int32 pos
    for tree, shardings in trees:
        leaves = jax.tree.leaves(tree)
        specs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
        assert len(leaves) == len(specs)
        for leaf, sharding in zip(leaves, specs):
            local = list(leaf.shape)
            for d, ax in enumerate(tuple(sharding.spec)):
                for a in (() if ax is None else ax if isinstance(ax, tuple)
                          else (ax,)):
                    local[d] //= mesh.shape[a]
            item = np.dtype(leaf.dtype).itemsize
            if tree is batch and np.issubdtype(leaf.dtype, np.integer):
                item = 8
            total += int(np.prod(local)) * item
    return total


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_mesh_argument_bytes_equal_the_references_specs(arch, shape, mesh_kind):
    # the argument bytes alone: the step's count over these meshes is
    # tests/test_torch_dryrun_mesh_counts.py's
    r = dryrun.dryrun_one(arch, shape, mesh_kind, save=False, step=False)
    assert r["n_chips"] == (512 if mesh_kind == "multi" else 256)
    assert r["mesh"] == mesh_kind
    mf = dryrun.model_flops(tconfigs.get_config(arch), shape)
    assert r["model_flops_global"] == mf
    assert r["model_flops_per_device"] == mf / r["n_chips"]
    assert r["per_device"]["argument_bytes"] == _reference_shard_bytes(
        arch, shape, mesh_kind)
    for absent in ("hlo_flops_per_device", "roofline", "temp_bytes",
                   "collective_bytes_per_device"):
        assert absent not in r


def test_mesh_shapes_at_function_level(small_shapes):
    """Any mesh shape: (data 4, model 1), (2, 2), (1, 4) over 4 cards, and
    the (1, 1) mesh's bytes equal to one card's."""
    from repro_torch.launch.mesh import mesh_shape
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    card = dryrun.dryrun_one("deepseek-7b", "tiny_train", "card", save=False,
                             cfg_override=cfg)
    one = dryrun.dryrun_one("deepseek-7b", "tiny_train", mesh_shape(1, 1),
                            save=False, cfg_override=cfg)
    assert one["mesh"] == "1x1" and one["n_chips"] == 1
    assert one["per_device"]["argument_bytes"] == card["per_device"]["argument_bytes"]
    for d, m in ((4, 1), (2, 2), (1, 4)):
        r = dryrun.dryrun_one("deepseek-7b", "tiny_train", mesh_shape(d, m),
                              save=False, cfg_override=cfg)
        assert (r["mesh"], r["n_chips"]) == (f"{d}x{m}", 4)
        assert r["per_device"]["argument_bytes"] < card["per_device"]["argument_bytes"]
    assert dryrun.np_prod_batch_shards(mesh_shape(4, 4, 2)) == 8
    assert dryrun.np_prod_batch_shards(mesh_shape(4, 4)) == 4


COMPILED = textwrap.dedent("""
    import json, os
    import jax, jax.numpy as jnp
    jax.devices()           # 16 host devices, before the dry run's module sets 512
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import get_config, reduced
    from repro.launch import dryrun as dr, mesh as mesh_lib
    from repro.models import lm as lm_lib
    from repro.sharding import rules as sh

    mesh = mesh_lib.make_host_mesh(data=4, model=4)
    cfg = reduced(get_config("deepseek-7b"))
    params = lm_lib.abstract_params(cfg, jnp.bfloat16)
    param_sh = sh.param_shardings(params, mesh, mode="train")
    batch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32),
             "labels": jax.ShapeDtypeStruct((8, 64), jnp.int32)}
    batch_sh = sh.batch_shardings(batch, mesh)
    opt, train_step = dr.build_train_step(cfg, num_microbatches=2)
    opt_state = jax.eval_shape(opt.init, params)
    opt_sh = sh.opt_state_shardings(opt_state, mesh)
    with mesh_lib.set_mesh(mesh):
        compiled = jax.jit(train_step,
                           in_shardings=(param_sh, opt_sh, batch_sh),
                           out_shardings=(param_sh, opt_sh,
                                          NamedSharding(mesh, P()))
                           ).lower(params, opt_state, batch).compile()
    print(json.dumps({"argument_size_in_bytes":
                      int(compiled.memory_analysis().argument_size_in_bytes)}))
""")


def test_mesh_argument_bytes_equal_the_compiled_programs(small_shapes, monkeypatch):
    """``tests/test_dryrun_small.py``'s setting (reduced deepseek-7b, data
    4 x model 4, B 8, S 64, M 2, bf16): the port's per-device argument
    bytes against XLA's compiled ``argument_size_in_bytes`` on 16 host
    devices.  They differ by exactly the tokens' and labels' width, 8
    bytes an element in the port and 4 in the reference (ROADMAP C15):
    4 bytes for each of the 2 x 8 x 64 / 4 local elements."""
    from repro_torch.launch.mesh import mesh_shape
    monkeypatch.setitem(tpipeline.SHAPES, "dryrun_small",
                        dict(seq_len=64, global_batch=8, kind="train"))
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    r = dryrun.dryrun_one("deepseek-7b", "dryrun_small", mesh_shape(4, 4),
                          save=False, cfg_override=cfg, force_microbatches=2)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    out = subprocess.run([sys.executable, "-c", COMPILED], capture_output=True,
                         text=True, env=env, timeout=480)
    assert out.returncode == 0, out.stderr[-3000:]
    xla = json.loads(out.stdout.strip().splitlines()[-1])["argument_size_in_bytes"]
    token_width = (8 - 4) * 2 * 8 * 64 // 4
    assert r["per_device"]["argument_bytes"] == xla + token_width
