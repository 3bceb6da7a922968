"""The dry run's per-device counts on a mesh: what ``dryrun_one`` counts for
one device on a fake world, on ``meta``, against what each rank of a real
4-rank gloo mesh counts running the same train step; and ``dryrun_one``
over the reference's production meshes.

The 4 ranks (subprocesses, one torch thread each, started once for the
module) run ``build_train_step`` (AdamW(1e-4), M 1, no codec) once under
``dryrun.StepCounter`` for the dense family (``deepseek-7b``) and the
MLA + MoE + first-dense family (``deepseek-v2-lite-16b``), each reduced
at d 1024, d_ff 1024, vocabulary 1024 (the rules place a dim over "data"
only from 1024 up), B 8, S 16, float32, from the port's seeded weights,
over (data 2, model 2) and (1, 4), every argument placed by the rules.
Then rank 0 destroys its gloo group and calls ``dryrun_one`` at the same
settings, which makes its own fake world of 4 ranks in that process: the
per-device FLOPs by op, and the collective bytes and calls by op, equal
every real rank's exactly.

Over ``single`` (16 x 16) and ``multi`` (2 x 16 x 16), the two held
families at a reduced config and a small train shape (B 64, S 64) report
the reference's keys (``hlo_flops_per_device``,
``collective_bytes_per_device`` by op with ``total``, ``roofline`` with
``collective_s``, ``dominant``, ``useful_flops_ratio``,
``hbm_bytes_floor``); every other family, at full width and train_4k,
records ``mesh_step`` with its reason and counts nothing, and no
combination raises."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.configs.archs import ALL_ARCHS  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
TIMEOUT_S = 600
ARCHS = ("deepseek-7b", "deepseek-v2-lite-16b")
MESHES = ((2, 2), (1, 4))
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
SMALL_TRAIN = dict(seq_len=64, global_batch=64, kind="train")

WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    ARCHS = ("deepseek-7b", "deepseek-v2-lite-16b")
    MESHES = ((2, 2), (1, 4))
    B, S = 8, 16
    OVERRIDES = dict(d_model=1024, d_ff=1024, vocab_size=1024)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.models import lm as lm_lib
    from repro_torch.sharding import rules

    out = {}
    g = torch.Generator().manual_seed(3)
    for arch in ARCHS:
        cfg = reduced(get_config(arch), **OVERRIDES)
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
                 for k in ("tokens", "labels")}
        for dn, mn in MESHES:
            mesh = mesh_lib.make_host_mesh(dn, mn, device_type="cpu")
            whole = lm_lib.init_lm_params(0, cfg, device="cpu")
            opt, step = dryrun.build_train_step(cfg)
            state = opt.init(whole)
            args = (rules.distribute_tree(
                        whole, rules.param_shardings(whole, mesh), mesh),
                    rules.distribute_tree(
                        state, rules.opt_state_shardings(state, mesh), mesh),
                    rules.distribute_tree(
                        batch, rules.batch_shardings(batch, mesh), mesh))
            with mesh_lib.set_mesh(mesh):
                _, counts = dryrun.count_step(step, *args)
            out[f"{arch} {dn}x{mn}"] = counts
    dist.destroy_process_group()
    # the fake world, made by the dry run in this process after the real
    # group is gone
    if rank == 0:
        pipeline.SHAPES["mesh_counts"] = dict(seq_len=S, global_batch=B,
                                              kind="train")
        for arch in ARCHS:
            cfg = reduced(get_config(arch), **OVERRIDES)
            out[f"card {arch}"] = dryrun.dryrun_one(
                arch, "mesh_counts", "card", save=False, cfg_override=cfg,
                param_dtype=torch.float32)["hlo_flops_per_device"]
            for dn, mn in MESHES:
                r = dryrun.dryrun_one(arch, "mesh_counts", mesh_shape(dn, mn),
                                      save=False, cfg_override=cfg,
                                      param_dtype=torch.float32)
                out[f"fake {arch} {dn}x{mn}"] = {
                    k: r[k] for k in ("hlo_flops_per_device", "flops_by_op",
                                      "collective_bytes_per_device",
                                      "collective_calls_per_device")}
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's counts of the real steps, and rank 0's fake-world
    counts."""
    tmp = tmp_path_factory.mktemp("mesh_counts")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
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
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_fake_world_counts_equal_every_real_ranks(ranks, arch, mesh):
    key = f"{arch} {mesh[0]}x{mesh[1]}"
    fake = ranks[0][f"fake {key}"]
    assert fake["hlo_flops_per_device"] > 0
    assert fake["hlo_flops_per_device"] == sum(fake["flops_by_op"].values())
    coll = fake["collective_bytes_per_device"]
    assert sorted(coll) == sorted(COLLECTIVES + ("total",))
    assert coll["total"] == sum(coll[k] for k in COLLECTIVES) > 0
    assert sorted(fake["collective_calls_per_device"]) == sorted(COLLECTIVES)
    for rank in ranks:
        assert rank[key] == fake, (key, rank[key], fake)


def test_fake_world_counts_per_device(ranks):
    """The counts are one device's: fewer matmul FLOPs than the same step
    counted whole on one card, and collectives over the mesh's axes."""
    for arch in ARCHS:
        for m in ("2x2", "1x4"):
            r = ranks[0][f"fake {arch} {m}"]
            assert 0 < r["hlo_flops_per_device"] < ranks[0][f"card {arch}"]
            assert r["collective_calls_per_device"]["all-gather"] > 0
            assert r["collective_calls_per_device"]["all-reduce"] > 0


REFERENCE_KEYS = ("hlo_flops_per_device", "collective_bytes_per_device",
                  "hbm_bytes_floor", "useful_flops_ratio", "roofline", "dominant",
                  "model_flops_per_device", "n_chips", "per_device")


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_production_meshes_report_the_references_keys(monkeypatch, arch,
                                                      mesh_kind):
    monkeypatch.setitem(tpipeline.SHAPES, "mesh_small", SMALL_TRAIN)
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    r = dryrun.dryrun_one(arch, "mesh_small", mesh_kind, save=False,
                          cfg_override=cfg)
    for k in REFERENCE_KEYS:
        assert k in r, k
    assert "mesh_step" not in r
    assert r["n_chips"] == (512 if mesh_kind == "multi" else 256)
    coll = r["collective_bytes_per_device"]
    assert sorted(coll) == sorted(COLLECTIVES + ("total",)) and coll["total"] > 0
    assert sorted(r["roofline"]) == ["collective_s", "compute_s", "memory_s"]
    assert r["roofline"]["collective_s"] == coll["total"] / dryrun.H100_NVLINK_BYTES_PER_S
    assert r["dominant"] == max(r["roofline"], key=r["roofline"].get)
    assert r["hbm_bytes_floor"] == r["per_device"]["argument_bytes"]
    assert r["useful_flops_ratio"] == (r["model_flops_per_device"]
                                       / r["hlo_flops_per_device"])
    # the fake world is gone: a later one can be made
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS if dryrun.mesh_step_gap(
    tconfigs.get_config(a), "train") is not None])
def test_other_families_record_why_no_step_is_counted(arch, mesh_kind):
    r = dryrun.dryrun_one(arch, "train_4k", mesh_kind, save=False)
    assert r["status"] == "ok" and r["per_device"]["argument_bytes"] > 0
    assert r["mesh_step"]["roadmap"] == "A23" and r["mesh_step"]["reason"]
    for absent in ("hlo_flops_per_device", "collective_bytes_per_device",
                   "roofline", "dominant"):
        assert absent not in r


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_steps_on_a_mesh_wait_for_serving_over_a_mesh(shape):
    r = dryrun.dryrun_one("deepseek-7b", shape, "single", save=False)
    assert r["mesh_step"]["roadmap"] == "A25"
    assert "hlo_flops_per_device" not in r


def test_held_families():
    """The families whose train step is counted on a mesh: every sublayer
    kind attention, MLA, MLP or MoE, with no frontend or encoder."""
    held = [a for a in ALL_ARCHS
            if dryrun.mesh_step_gap(tconfigs.get_config(a), "train") is None]
    assert sorted(held) == sorted(["deepseek-7b", "qwen2.5-32b", "mistral-large-123b",
                                   "chatglm3-6b", "phi3.5-moe-42b-a6.6b",
                                   "deepseek-v2-lite-16b"])
