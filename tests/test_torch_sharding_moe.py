"""The MoE family's train step on a mesh: the port's ``build_train_step``
over DTensors placed by ``sharding.rules`` on a 4-rank gloo mesh, held
against the same step unsharded and against the reference's step jitted
with the rules' ``in_shardings`` on 4 host devices.

One process group of 4 gloo ranks (subprocesses, one torch thread each)
runs every port case, and one reference subprocess with
``--xla_force_host_platform_device_count=4`` the reference's case, both
once for the module and at the same time.  The model is
``deepseek-v2-lite-16b`` reduced (the first dense superblock and 2
MLA + MoE superblocks, 4 experts, top-2, capacity factor 1.25, one shared
expert) at d 1024, d_ff 1024, vocabulary 1024 (the rules place a dim over
"data" only from 1024 up), B 8, S 16, float32, ``c3sl:R=4`` at the
midpoint, AdamW(1e-4), 2 steps, from the reference's weights
(``PRNGKey(0)``) and C3-SL keys (``PRNGKey(7)``).

Cases: (data 2, model 2), (4, 1) and (1, 4), each at M 1 and M 2; on
(1, 4) each rank holds one expert.  Each rank's routing of every MoE call
of the first step (the forward's and the recomputed one's, each
microbatch's), as ``moe.route`` returns it on that rank's token rows,
equals the unsharded port's rows exactly: the expert indices, the kept
copies and each copy's slot in the global capacity order, with copies
dropped.  The loss of each step within 1e-6 relative, the first step's
AdamW moments within 2e-5 of each leaf's max, and the params after the
two steps within 2e-5 of each leaf's L2 norm and 2 lr a step elementwise,
as ``tests/test_torch_sharding_step.py`` holds the dense step; the (2, 2)
case at M 1 the same against the reference's jitted step."""
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
ROUTING = ("expert_idx", "keep", "dest")

COMMON = textwrap.dedent("""
    import numpy as np
    ARCH = "deepseek-v2-lite-16b"
    B, S, STEPS = 8, 16, 2
    OVERRIDES = dict(d_model=1024, d_ff=1024, vocab_size=1024)
    C3SL = "c3sl:R=4"
    MESHES = [(2, 2), (4, 1), (1, 4)]
    CASES = [(dn, mn, M) for dn, mn in MESHES for M in (1, 2)]

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

    def case_key(data, model, M=1):
        return f"{data}x{model}-M{M}"

    def plain_key(M=1):
        return f"plain-M{M}"
""")
exec(COMMON)  # noqa: S102  (ARCH, B, S, STEPS, OVERRIDES, C3SL, CASES, ...)

REFERENCE = COMMON + textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    jax.devices()           # 4 host devices, before the dry run's module sets 512
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import transport
    from repro.configs.base import get_config, reduced
    from repro.launch import dryrun as dr, mesh as mesh_lib
    from repro.sharding import rules as sh

    inp, out_path = sys.argv[1], sys.argv[2]
    data = np.load(inp)
    cfg = reduced(get_config(ARCH), **OVERRIDES)
    params = jax.tree.map(jnp.asarray, nest({k[2:]: data[k] for k in data.files
                                             if k.startswith("p/")}))
    batch = {k: jnp.asarray(data[k], jnp.int32) for k in ("tokens", "labels")}
    mesh = mesh_lib.make_host_mesh(data=2, model=2)
    param_sh = sh.param_shardings(params, mesh)
    batch_sh = sh.batch_shardings(batch, mesh)
    codec = transport.build_link_or_codec(C3SL, D=S * cfg.d_model)
    cp = codec.init(jax.random.PRNGKey(7))
    opt, train_step = dr.build_train_step(cfg, codec, cp)
    opt_state = opt.init(params)
    opt_sh = sh.opt_state_shardings(opt_state, mesh)
    with mesh_lib.set_mesh(mesh):
        fn = jax.jit(train_step, in_shardings=(param_sh, opt_sh, batch_sh),
                     out_shardings=(param_sh, opt_sh, NamedSharding(mesh, P())))
        p = jax.device_put(params, param_sh)
        s = jax.device_put(opt_state, opt_sh)
        b = jax.device_put(batch, batch_sh)
        losses = []
        for i in range(STEPS):
            p, s, loss = fn(p, s, b)
            losses.append(float(loss))
            if i == 0:
                first = {"m": s["m"], "v": s["v"]}
    key = case_key(2, 2)
    out = {f"{key}/loss": np.asarray(losses, np.float64)}
    for path, v in flat({"p": p, "first": first}).items():
        out[f"{key}/{path}"] = np.asarray(v)
    np.savez(out_path, **out)
""")

WORKER = COMMON + textwrap.dedent("""
    import contextlib, sys
    import torch
    import torch.distributed as dist
    rank, port, inp, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from repro_torch import codecs
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.sharding import rules

    # every routing moe.route returns, on this rank's rows, as it runs
    routes, route_fn = [], moe.route

    def recording_route(*args, **kw):
        r = route_fn(*args, **kw)
        routes.append({k: r[k].numpy().copy() for k in ("expert_idx", "keep",
                                                        "dest")})
        return r

    moe.route = recording_route

    data = np.load(inp)
    params_np = nest({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    batch_np = {k: torch.from_numpy(data[k].astype(np.int64))
                for k in ("tokens", "labels")}
    cfg = reduced(get_config(ARCH), **OVERRIDES)
    keys = torch.from_numpy(data["keys"])
    codec = codecs.build(C3SL, D=S * cfg.d_model)
    cp = {"keys": keys, "keys_fft": torch.fft.rfft(keys, dim=-1)}
    out = {}

    def run(M, params, batch, mesh=None):
        opt, step = dryrun.build_train_step(cfg, codec, cp, num_microbatches=M)
        if mesh is None:
            opt_state = opt.init(params)
        else:
            whole = opt.init(params_from_numpy(params_np, "cpu"))
            opt_state = rules.distribute_tree(
                whole, rules.opt_state_shardings(whole, mesh), mesh)
        losses = []
        del routes[:]
        with mesh_lib.set_mesh(mesh) if mesh else contextlib.nullcontext():
            for i in range(STEPS):
                params, opt_state, loss = step(params, opt_state, batch)
                losses.append(float(loss.full_tensor() if mesh else loss))
                if i == 0:          # every rank joins the gathers; copies,
                    # as the updates write the plain state in place
                    first = {k: np.array(v) for k, v in flat(params_to_numpy(
                        {"m": opt_state["m"], "v": opt_state["v"]})).items()}
                    calls = list(routes)
        return {"p": params, "first": first}, losses, calls

    def record(key, state, losses, calls, whole=True):
        for i, call in enumerate(calls):
            for k, v in call.items():
                out[f"{key}/route/{i}/{k}"] = v
        out[f"{key}/calls"] = np.asarray(len(calls))
        tree = dict(params_to_numpy({"p": state["p"]}), first=nest(state["first"]))
        if whole:
            out[f"{key}/loss"] = np.asarray(losses, np.float64)
            for path, v in flat(tree).items():
                out[f"{key}/{path}"] = v

    # the unsharded step, on rank 0
    if rank == 0:
        for M in (1, 2):
            record(plain_key(M), *run(M, params_from_numpy(params_np, "cpu"),
                                      batch_np))

    for dn, mn, M in CASES:
        key = case_key(dn, mn, M)
        mesh = mesh_lib.make_host_mesh(dn, mn, device_type="cpu")
        params = params_from_numpy(params_np, "cpu", mesh=mesh)
        batch = rules.distribute_tree(
            batch_np, rules.batch_shardings(batch_np, mesh), mesh)
        out[f"{key}/coord"] = np.asarray(mesh.device_mesh.get_coordinate())
        record(key, *run(M, params, batch, mesh), whole=rank == 0)
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
    tmp = tmp_path_factory.mktemp("sharding_moe")
    cfg = jconfigs.reduced(jconfigs.get_config(ARCH), **OVERRIDES)
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
def test_moe_step_matches_the_unsharded_step(runs, case):
    _, ranks = runs
    _hold(_gaps(ranks[0], ranks[0], case_key(*case), plain_key(case[2])))


def test_moe_step_matches_the_reference(runs):
    ref, ranks = runs
    _hold(_gaps(ranks[0], ref, case_key(2, 2), case_key(2, 2)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: case_key(*c))
def test_routing_equals_the_unsharded_routing(runs, case):
    """Every MoE call of the first step (each microbatch's forward and
    recomputed calls): each rank's expert indices, kept copies and slots
    are the unsharded call's for that rank's rows, which are the
    microbatch's rows split over "data" (every rank its own consecutive
    share), or all of them past the cut where a C3-SL group spans ranks
    (the cut gathers the rows, ``constraints.on_local_rows``); the
    capacity is the global one, so copies are dropped."""
    _, ranks = runs
    dn, mn, M = case
    plain = ranks[0]
    n = int(plain[f"{plain_key(M)}/calls"])
    # the first dense superblock has no router: 2 MoE superblocks, each
    # called in the forward and in the backward's recompute, per microbatch
    assert n == 2 * 2 * M
    dropped = 0
    for rank in ranks:
        key = case_key(dn, mn, M)
        assert int(rank[f"{key}/calls"]) == n
        for c in range(n):
            i = int(rank[f"{key}/coord"][0])
            want = {k: plain[f"{plain_key(M)}/route/{c}/{k}"] for k in ROUTING}
            got = {k: rank[f"{key}/route/{c}/{k}"] for k in ROUTING}
            rows = len(got["expert_idx"])
            assert rows in (len(want["expert_idx"]) // dn, len(want["expert_idx"]))
            if rows == len(want["expert_idx"]):
                i = 0
            copies = rows * want["expert_idx"].shape[1]
            sl = {"expert_idx": slice(i * rows, (i + 1) * rows),
                  "keep": slice(i * copies, (i + 1) * copies),
                  "dest": slice(i * copies, (i + 1) * copies)}
            for k in ROUTING:
                np.testing.assert_array_equal(got[k], want[k][sl[k]],
                                              err_msg=f"{key} call {c} {k}")
            dropped += int((~want["keep"]).sum())
    assert dropped > 0
