"""The dry run's train step on a mesh: the port's ``build_train_step`` over
DTensors placed by ``sharding.rules`` on a 4-rank gloo mesh, held against
the same step unsharded and against the reference's step jitted with the
rules' ``in_shardings`` on 4 host devices (``_lower_and_compile``'s
program, executed).

One process group of 4 gloo ranks (subprocesses, one torch thread each)
runs every port case, and one reference subprocess with
``--xla_force_host_platform_device_count=4`` every reference case, both
once for the module and at the same time.  The model is ``deepseek-7b``
reduced to 2 superblocks at d 1024, d_ff 1024, vocabulary 1024 (the rules
place a dim over "data" only from 1024 up, so at ``reduced()``'s widths
nothing would be), B 8, S 16, float32, AdamW(1e-4), 2 steps, from the
reference's weights (``PRNGKey(0)``) and C3-SL keys (``PRNGKey(7)``).

Cases: (data 2, model 2) without a codec and with ``c3sl:R=4`` (each rank
holds 4 rows: one group), held to the port's unsharded step and to the
reference's; (data 4, model 1) with ``c3sl:R=4``, where a group spans
ranks (2 rows a rank), held to the port's unsharded step.  The loss of
each step within 1e-6 relative and the gradients (as AdamW's moments
after the first step) within 2e-5 of each leaf's max, as
``tests/test_torch_lm_train.py`` holds them.  The params after the two
steps are held looser, with the cause: AdamW moves an element by up to
about lr a step whatever |g| is, so where a gradient element is at its
rounding (a sum that cancels), a rounding flips its step (measured: 1.5
lr on about 70 of the model's 11.5M elements, none of the c3sl cases
past 0.3 lr).  Each param leaf is held to 2e-5 of its norm in L2 and to
2 lr a step elementwise.  On the (2, 2) mesh
each rank's local shard of a param placed over both axes, and of the
sharded carry, equals the reference's shard on the device at the same
mesh coordinates.  Each rank's rows of each microbatch, as the step's
loss got them and as ``constraints.microbatch`` gives them alone, are its
own share of that microbatch's rows, and the cut's codec ran on the rows
each case implies."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import transport as jtransport  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_TOL = 1e-6          # |loss difference| / |loss|
GRAD_TOL = 2e-5          # max |moment difference| / max |moment|, per leaf
LEAF_TOL = 2e-5          # |param difference| / |param| in L2, per leaf
LR = 1e-4                # build_train_step's AdamW
WORLD = 4
TIMEOUT_S = 600

COMMON = textwrap.dedent("""
    import numpy as np
    B, S, STEPS = 8, 16, 2
    OVERRIDES = dict(d_model=1024, d_ff=1024, vocab_size=1024)
    C3SL = "c3sl:R=4"
    # (data, model, codec, microbatches): the port runs each; the
    # reference the (2, 2) ones at M 1
    CASES = [(2, 2, "none", 1), (2, 2, C3SL, 1), (4, 1, C3SL, 1),
             (2, 2, C3SL, 2)]
    # microbatch counts taken alone on each case's mesh: B / M rows over
    # data 2 or 4, evenly or (M 8 on data 4: one row) not
    MICROBATCHES = (2, 4, 8)
    SHARD_LEAF = "stack/l0_0_attn/w_q"        # (None, "data", "model") at (2, 2)

    def nest(flat):
        out = {}
        for path, v in flat.items():
            *head, last = path.split("/")
            d = out
            for k in head:
                d = d.setdefault(k, {})
            d[last] = v
        return out

    def flat(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            v, path = tree[k], f"{prefix}{k}"
            out.update(flat(v, path + "/") if isinstance(v, dict) else {path: v})
        return out

    def case_key(data, model, spec, M=1):
        return (f"{data}x{model}-{'c3sl' if spec == C3SL else spec}"
                + (f"-M{M}" if M > 1 else ""))

    def plain_key(spec, M=1):
        return f"plain-{spec}" + (f"-M{M}" if M > 1 else "")
""")
exec(COMMON)  # noqa: S102  (B, S, STEPS, OVERRIDES, C3SL, CASES, nest, flat, ...)

REFERENCE = COMMON + textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    jax.devices()           # 4 host devices, before the dry run's module sets 512
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import transport
    from repro.configs.base import get_config, reduced
    from repro.launch import dryrun as dr, mesh as mesh_lib
    from repro.models import lm as lm_lib, stack as stack_lib
    from repro.sharding import rules as sh

    inp, out_path = sys.argv[1], sys.argv[2]
    data = np.load(inp)
    cfg = reduced(get_config("deepseek-7b"), **OVERRIDES)
    params = jax.tree.map(jnp.asarray, nest({k[2:]: data[k] for k in data.files
                                             if k.startswith("p/")}))
    batch = {k: jnp.asarray(data[k], jnp.int32) for k in ("tokens", "labels")}
    mesh = mesh_lib.make_host_mesh(data=2, model=2)
    coords = {d.id: tuple(int(i) for i in ix)
              for ix, d in np.ndenumerate(mesh.devices)}
    param_sh = sh.param_shardings(params, mesh)
    batch_sh = sh.batch_shardings(batch, mesh)
    repl = NamedSharding(mesh, P())
    out = {}

    def shards(x, name):
        for s in x.addressable_shards:
            i, j = coords[s.device.id]
            out[f"{name}/{i}{j}"] = np.asarray(s.data)

    for dn, mn, spec, M in CASES:
        if (dn, mn, M) != (2, 2, 1):
            continue
        key = case_key(dn, mn, spec)
        codec = cp = None
        if spec != "none":
            codec = transport.build_link_or_codec(spec, D=S * cfg.d_model)
            cp = codec.init(jax.random.PRNGKey(7))
        opt, train_step = dr.build_train_step(cfg, codec, cp)
        opt_state = opt.init(params)
        opt_sh = sh.opt_state_shardings(opt_state, mesh)
        with mesh_lib.set_mesh(mesh):
            fn = jax.jit(train_step, in_shardings=(param_sh, opt_sh, batch_sh),
                         out_shardings=(param_sh, opt_sh, repl))
            p = jax.device_put(params, param_sh)
            s = jax.device_put(opt_state, opt_sh)
            b = jax.device_put(batch, batch_sh)
            losses = []
            for i in range(STEPS):
                p, s, loss = fn(p, s, b)
                losses.append(float(loss))
                if i == 0:
                    first = {"m": s["m"], "v": s["v"]}
        out[f"{key}/loss"] = np.asarray(losses, np.float64)
        for path, v in flat({"p": p, "first": first}).items():
            out[f"{key}/{path}"] = np.asarray(v)
        if spec == "none":
            leaf = p
            for k in SHARD_LEAF.split("/"):
                leaf = leaf[k]
            shards(leaf, "shard")

    def carry(params, batch):
        h, positions = lm_lib._embed_inputs(params, cfg, batch)
        h, _ = stack_lib.apply_stack(params["stack"], cfg, h, positions,
                                     remat=False)
        return h

    with mesh_lib.set_mesh(mesh):
        h = jax.jit(carry, in_shardings=(param_sh, batch_sh))(params, batch)
    shards(h, "carry")
    out["carry_spec"] = np.asarray(json.dumps(
        [list(e) if isinstance(e, tuple) else e for e in h.sharding.spec]))
    np.savez(out_path, **out)
""")

WORKER = COMMON + textwrap.dedent("""
    import contextlib, json, sys
    import torch
    import torch.distributed as dist
    rank, port, inp, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import codecs
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.models import lm as lm_lib, stack as stack_lib
    from repro_torch.interop import tree_map
    from repro_torch.optim import clip_by_global_norm_, global_norm
    from repro_torch.sharding import constraints, rules

    # what the step's loss and the cut's codec are handed, as they run
    seen_batches, seen_rows = [], []
    loss_fn, roundtrip_fn = lm_lib.lm_loss, lm_lib.roundtrip

    def recording_loss(params, batch, cfg, **kw):
        seen_batches.append(batch["tokens"])
        return loss_fn(params, batch, cfg, **kw)

    def recording_roundtrip(codec, cp, z, **kw):
        seen_rows.append(z.shape[0])
        return roundtrip_fn(codec, cp, z, **kw)

    lm_lib.lm_loss, lm_lib.roundtrip = recording_loss, recording_roundtrip

    def record_rows(key, x, M, m):
        out[f"rows/{key}/{m}/placements"] = np.asarray(str(tuple(x.placements)))
        out[f"rows/{key}/{m}/tokens"] = x.to_local().numpy()

    data = np.load(inp)
    params_np = nest({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    batch_np = {k: torch.from_numpy(data[k].astype(np.int64))
                for k in ("tokens", "labels")}
    cfg = reduced(get_config("deepseek-7b"), **OVERRIDES)
    out = {}

    def codec_for(spec):
        if spec == "none":
            return None, None
        keys = torch.from_numpy(data["keys"])
        return (codecs.build(spec, D=S * cfg.d_model),
                {"keys": keys, "keys_fft": torch.fft.rfft(keys, dim=-1)})

    def run(spec, M, params, batch, mesh=None):
        codec, cp = codec_for(spec)
        opt, step = dryrun.build_train_step(cfg, codec, cp, num_microbatches=M)
        if mesh is None:
            opt_state = opt.init(params)
        else:
            whole = opt.init(params_from_numpy(params_np, "cpu"))
            opt_state = rules.distribute_tree(
                whole, rules.opt_state_shardings(whole, mesh), mesh)
        losses = []
        with mesh_lib.set_mesh(mesh) if mesh else contextlib.nullcontext():
            for i in range(STEPS):
                params, opt_state, loss = step(params, opt_state, batch)
                losses.append(float(loss.full_tensor() if mesh else loss))
                if i == 0:          # every rank joins the gathers; copies,
                    # as the updates write the plain state in place
                    first = {k: np.array(v) for k, v in flat(params_to_numpy(
                        {"m": opt_state["m"], "v": opt_state["v"]})).items()}
        return {"p": params, "first": first}, losses

    # the unsharded step, on rank 0
    if rank == 0:
        for spec, M in sorted({(c[2], c[3]) for c in CASES}):
            state, losses = run(spec, M, params_from_numpy(params_np, "cpu"),
                                batch_np)
            out[f"{plain_key(spec, M)}/loss"] = np.asarray(losses, np.float64)
            whole = dict(params_to_numpy({"p": state["p"]}),
                         first=nest(state["first"]))
            for path, v in flat(whole).items():
                out[f"{plain_key(spec, M)}/{path}"] = v

    for dn, mn, spec, M in CASES:
        key = case_key(dn, mn, spec, M)
        mesh = mesh_lib.make_host_mesh(dn, mn, device_type="cpu")
        dm = mesh.device_mesh
        specs = rules.param_shardings(params_np, mesh)
        out[f"{key}/axes"] = np.asarray(json.dumps(sorted(
            {a for s in flat(specs).values() for e in s if e is not None
             for a in (e if isinstance(e, tuple) else (e,))})))
        params = params_from_numpy(params_np, "cpu", mesh=mesh)
        batch = rules.distribute_tree(
            batch_np, rules.batch_shardings(batch_np, mesh), mesh)
        if key == "2x2-none":
            out["global_norm"] = np.asarray(
                float(global_norm(params).full_tensor()))
            plain = params_from_numpy(params_np, "cpu")
            out["global_norm_plain"] = np.asarray(float(global_norm(plain)))
            # clipped in place to half the norm, on copies
            half = 0.5 * float(out["global_norm_plain"])
            clipped = tree_map(lambda t: t.clone(), params)
            clip_by_global_norm_(clipped, half)
            clip_by_global_norm_(plain, half)
            out["clipped"] = params_to_numpy(clipped)["head"]
            out["clipped_plain"] = plain["head"].numpy()
            with mesh_lib.set_mesh(mesh), implicit_replication(), torch.no_grad():
                h, pos = lm_lib._embed_inputs(params, cfg, batch)
                h, _ = stack_lib.apply_stack(params["stack"], cfg, h, pos,
                                             remat=False)
            i, j = dm.get_coordinate()
            out[f"carry/{i}{j}"] = h.to_local().numpy()
            out["carry_placements"] = np.asarray(str(tuple(h.placements)))
        # microbatches taken alone, on this mesh, beside the step's own
        for Mx in MICROBATCHES:
            for m in range(Mx):
                record_rows(f"{dn}x{mn}-M{Mx}",
                            constraints.microbatch(batch["tokens"], Mx, m), Mx, m)
        del seen_batches[:], seen_rows[:]
        state, losses = run(spec, M, params, batch, mesh)
        # the first step's microbatches as the loss got them, and the rows
        # the cut's codec ran on in each (groups of 4 of a microbatch's rows)
        for m, x in enumerate(seen_batches[:M]):
            record_rows(key, x, M, m)
        out[f"{key}/codec_rows"] = np.asarray(seen_rows, np.int64)
        if key == "2x2-none":
            leaf = state["p"]
            for k in SHARD_LEAF.split("/"):
                leaf = leaf[k]
            i, j = dm.get_coordinate()
            out[f"shard/{i}{j}"] = leaf.to_local().numpy()
        whole = dict(params_to_numpy({"p": state["p"]}),
                     first=nest(state["first"]))
        if rank == 0:
            out[f"{key}/loss"] = np.asarray(losses, np.float64)
            for path, v in flat(whole).items():
                out[f"{key}/{path}"] = v
        out[f"{key}/coord"] = np.asarray(dm.get_coordinate())
    out["tokens"] = data["tokens"]
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the 4 ranks' results, from one reference
    subprocess and one 4-rank process group started together."""
    tmp = tmp_path_factory.mktemp("sharding")
    cfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **OVERRIDES)
    params = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1                      # masked positions
    jc = jtransport.build_link_or_codec(C3SL, D=S * cfg.d_model)
    keys = np.asarray(jc.init(jax.random.PRNGKey(7))["keys"])
    inp = tmp / "inputs.npz"
    np.savez(inp, tokens=tokens, labels=labels, keys=keys,
             **{f"p/{k}": v for k, v in flat(params).items()})

    base = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    ref_env = dict(base, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(inp),
                               str(tmp / "reference.npz")], env=ref_env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                                str(inp), str(tmp)], env=base,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err[-3000:]))
    for rc, err in errs:
        assert rc == 0, err
    ref = dict(np.load(tmp / "reference.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ref, ranks


def _gaps(got: dict, want: dict, key_got: str, key_want: str) -> dict:
    """Two runs' worst gaps: the loss (relative, over the steps), the
    first step's moments (of each leaf's max), the params after the steps
    (of each leaf's L2 norm, and elementwise in units of lr)."""
    lg, lw = got[f"{key_got}/loss"], want[f"{key_want}/loss"]
    assert len(lg) == len(lw) == STEPS

    def leaves(run, key, part):
        pre = f"{key}/{part}/"
        return {k[len(pre):]: v for k, v in run.items() if k.startswith(pre)}

    out = {"loss": float(np.max(np.abs(lg - lw) / np.abs(lw)))}
    for part in ("first", "p"):
        a, b = leaves(got, key_got, part), leaves(want, key_want, part)
        assert b and sorted(a) == sorted(b)
        if part == "first":
            out["moments"] = max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
                                 for k in b)
        else:
            out["params_l2"] = max(float(np.linalg.norm(a[k] - b[k])
                                         / np.linalg.norm(b[k])) for k in b)
            out["params_lr"] = max(float(np.abs(a[k] - b[k]).max()) / LR
                                   for k in b)
    return out


def _hold(g: dict):
    assert (g["loss"] <= LOSS_TOL and g["moments"] <= GRAD_TOL
            and g["params_l2"] <= LEAF_TOL and g["params_lr"] <= 2 * STEPS), g


@pytest.mark.parametrize("case", CASES, ids=lambda c: case_key(*c))
def test_sharded_step_matches_the_unsharded_step(runs, case):
    _, ranks = runs
    _hold(_gaps(ranks[0], ranks[0], case_key(*case), plain_key(*case[2:])))


@pytest.mark.parametrize("case", [c for c in CASES if c[:2] == (2, 2) and c[3] == 1],
                         ids=lambda c: case_key(*c))
def test_sharded_step_matches_the_reference(runs, case):
    ref, ranks = runs
    key = case_key(*case)
    _hold(_gaps(ranks[0], ref, key, key))


@pytest.mark.parametrize("case", CASES, ids=lambda c: case_key(*c))
def test_every_mesh_axis_places_a_leaf(runs, case):
    _, ranks = runs
    assert json.loads(str(ranks[0][f"{case_key(*case)}/axes"])) == ["data", "model"]


def _rows_per_rank(data: int, M: int) -> int:
    """The rows of a microbatch each rank holds: its share over "data"
    where they divide, else all of them."""
    rows = B // M
    return rows // data if rows % data == 0 else rows


@pytest.mark.parametrize("case", CASES, ids=lambda c: case_key(*c))
def test_codec_rows_on_each_rank(runs, case):
    """The rows the cut's codec ran on, on every rank and in every call of
    the step: a rank's 4 rows are one C3-SL group on (2, 2); on (4, 1),
    and for a microbatch of 4 rows on (2, 2), a group would span ranks (2
    rows each), so every rank gathers the microbatch's rows.  Without a
    codec nothing ran."""
    _, ranks = runs
    dn, _, spec, M = case
    r = _rows_per_rank(dn, M)
    want = [] if spec == "none" else [r if r % 4 == 0 else B // M] * (STEPS * M)
    assert all(r_[f"{case_key(*case)}/codec_rows"].tolist() == want
               for r_ in ranks)


ROW_CASES = ([("step", c[0], c[1], c[3], case_key(*c)) for c in CASES]
             + [("alone", dn, mn, Mx, f"{dn}x{mn}-M{Mx}")
                for dn, mn in ((2, 2), (4, 1)) for Mx in MICROBATCHES])


@pytest.mark.parametrize("case", ROW_CASES, ids=lambda c: f"{c[0]}-{c[4]}")
def test_microbatch_keeps_each_ranks_rows(runs, case):
    """Each rank's rows of each microbatch, as the step's loss got them
    and as ``constraints.microbatch`` gives them alone: split over "data"
    (each rank its own consecutive share of microbatch m's rows, B / M of
    the batch from row m B / M) where they divide, else replicated."""
    _, ranks = runs
    _, dn, mn, M, key = case
    tokens = ranks[0]["tokens"]
    r = _rows_per_rank(dn, M)
    split = r < B // M
    want = "(Shard(dim=0), Replicate())" if split else "(Replicate(), Replicate())"
    for rank in ranks:
        i = int(rank[f"{case_key(dn, mn, C3SL)}/coord"][0]) if split else 0
        for m in range(M):
            start = m * (B // M) + i * r
            np.testing.assert_array_equal(rank[f"rows/{key}/{m}/tokens"],
                                          tokens[start:start + r])
            assert str(rank[f"rows/{key}/{m}/placements"]) == want


@pytest.mark.parametrize("name", ["shard", "carry"])
def test_local_shards_equal_the_references(runs, name):
    """Each rank's ``to_local()`` against the reference's shard on the
    device at the same (data, model) coordinates: ``SHARD_LEAF`` after the
    two steps of the (2, 2) case without a codec, and the carry of the
    stack (sequence-sharded by the activation constraint) from the
    weights before them."""
    ref, ranks = runs
    if name == "carry":
        # jax prints the constraint's ("data",), "model", None as
        # P("data", "model"): one name for a 1-tuple, no trailing None
        assert json.loads(str(ref["carry_spec"])) == ["data", "model"]
        assert all(str(r["carry_placements"]) == "(Shard(dim=0), Shard(dim=1))"
                   for r in ranks)
    got = {k: v for r in ranks for k, v in r.items() if k.startswith(f"{name}/")}
    want = {k: v for k, v in ref.items() if k.startswith(f"{name}/")}
    assert sorted(got) == sorted(want) == [f"{name}/{i}{j}" for i in (0, 1)
                                          for j in (0, 1)]
    if name == "carry":          # the forward from the same weights
        top = max(np.abs(v).max() for v in want.values())
        for k in want:
            assert got[k].shape == want[k].shape
            assert np.abs(got[k] - want[k]).max() <= GRAD_TOL * top, k
    else:                        # a param after the two steps
        for k in want:
            assert got[k].shape == want[k].shape
            assert (np.linalg.norm(got[k] - want[k])
                    <= LEAF_TOL * np.linalg.norm(want[k])), k
            assert np.abs(got[k] - want[k]).max() <= 2 * STEPS * LR, k


def test_global_norm_reduces_over_every_rank(runs):
    """``global_norm`` of the (2, 2) mesh's DTensor params against the
    same params whole (a sum of one rank's squares would be about half),
    and ``clip_by_global_norm_`` to half that norm on both."""
    _, ranks = runs
    want = float(ranks[0]["global_norm_plain"])
    for r in ranks:
        got = float(r["global_norm"])
        assert abs(got - want) <= LOSS_TOL * want, (got, want)
    a, b = ranks[0]["clipped"], ranks[0]["clipped_plain"]
    assert np.abs(a - b).max() <= LOSS_TOL * np.abs(b).max()
