"""The port's training driver (``repro_torch.launch.train``), its token
data and its checkpoints, held against the reference's.

``run_standard`` of both packages runs the same flags from the same step-0
weights and codec keys (the reference's inits, carried across through
numpy); the port's log lines are parsed beside the reference's.  Exactly
equal: the dataset's tokens, the wire bytes of every step, the served R of
every step (Adaptive-R and the link's two channels), the steps a fault plan
skips, the boundary-traffic total.  To a tolerance: the losses.  Sizes are
``reduced()`` configs at S = 8 (D = 2048), a few steps each."""
import contextlib
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

# float32 on both sides: three steps of AdamW from the same weights; the
# gradients agree to a few 1e-6 of their max (tests/test_torch_lm_train.py),
# so the losses to well under 1e-4 relative; through int8 a flipped
# rounding moves a payload element by a quantization step
LOSS_RTOL = 1e-4

STEP = re.compile(r"^step +(\d+) (?:loss ([-\d.]+) gnorm [-\d.]+(.*?) \||SKIPPED)")


def _args(*argv):
    return ttrain.build_parser().parse_args(
        ["--reduced", "--seq", "8", "--batch", "8", "--log-every", "1",
         "--device", "cpu", *argv])


def _run(pkg, args, **kw):
    """(losses, stdout lines) of one package's run_standard."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if pkg == "ref":
            losses = jtrain.run_standard(args, jconfigs.reduced(
                jconfigs.get_config(args.arch)))
        else:
            losses = ttrain.run_standard(args, tconfigs.reduced(
                tconfigs.get_config(args.arch)), **kw)
    return losses, out.getvalue().splitlines()


def _same_start(args):
    """The reference run's step-0 params and codec params, as the port's."""
    cfg = jconfigs.reduced(jconfigs.get_config(args.arch))
    params = jlm.init_lm_params(jax.random.PRNGKey(args.seed), cfg)
    _, cp = jtrain.make_codec(args.codec, args.seq * cfg.d_model, R=args.R,
                              quant=args.quant, unitary=args.unitary,
                              max_R=args.batch)
    conv = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return {"params": conv(params),
            "codec_params": None if cp is None else conv(cp)}


def _steps(lines):
    """step -> (loss or None if skipped, the schedule part of the line:
    R, wire bytes, erasures; the SNRs dropped)."""
    got = {}
    for line in lines:
        m = STEP.match(line)
        if m:
            sched = re.sub(r" (?:grad-)?snr [-\d.]+dB| \(ema [-\d.]+\)", "",
                           m.group(3) or "")
            got[int(m.group(1))] = (None if m.group(2) is None
                                    else float(m.group(2)), sched.strip())
    return got


def _totals(lines):
    return [ln for ln in lines if ln.startswith(("boundary traffic", "[faults]"))]


@pytest.mark.parametrize("argv", [
    ("--codec", "none"),
    ("--codec", "c3sl:R=4|int8"),
    ("--codec", "adaptive:c3sl:R=8,min_R=2,target_snr=-3.5"),
    ("--codec", "adaptive:c3sl:R=4,min_R=2,target_snr=-4 >> "
                "bwd:adaptive:c3sl:R=2,min_R=1,target_snr=-3"),
    ("--codec", "c3sl:R=2", "--fault-drop", "0.4", "--fault-mode", "retransmit"),
    ("--codec", "c3sl:R=2 >> bwd:c3sl:R=1", "--fault-drop", "0.2")],
    ids=["none", "int8", "adaptive", "adaptive-link", "faults-retransmit",
         "faults-erasure-link"])
def test_run_standard_matches_reference(argv):
    """Four steps: the losses within LOSS_RTOL; per step, the served R and
    the wire bytes (and erasure and retransmission figures) exactly; the
    steps skipped as unrecoverable exactly; the totals exactly."""
    args = _args("--steps", "4", *argv)
    ref_losses, ref_lines = _run("ref", args)
    losses, lines = _run("port", args, **_same_start(args))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    ref_steps, steps = _steps(ref_lines), _steps(lines)
    assert sorted(steps) == sorted(ref_steps) == list(range(4))
    for s in range(4):
        assert steps[s][1] == ref_steps[s][1], (s, steps[s], ref_steps[s])
        assert (steps[s][0] is None) == (ref_steps[s][0] is None), s
    assert _totals(lines) == _totals(ref_lines)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "seamless-m4t-large-v2"])
def test_run_standard_other_families_match_reference(arch, monkeypatch):
    """MoE + MLA with a first dense layer, and the encoder-decoder with its
    audio frontend: three steps through ``c3sl:R=2``, the losses within
    LOSS_RTOL, the wire bytes of each step and the totals exactly, and the
    frontend batch the step sees the reference driver's: zeros of the same
    shape and dtype, on the run's device (the reference's, traced under
    jit, gives its shape and dtype)."""
    seen = {}
    for pkg, mod in (("ref", jlm), ("port", tlm)):
        real = mod.lm_loss

        def spy(params, batch, cfg, *a, _pkg=pkg, _real=real, **kw):
            seen.setdefault(_pkg, batch.get("frontend"))
            return _real(params, batch, cfg, *a, **kw)
        monkeypatch.setattr(mod, "lm_loss", spy)
    args = _args("--steps", "3", "--arch", arch, "--codec", "c3sl:R=2")
    ref_losses, ref_lines = _run("ref", args)
    losses, lines = _run("port", args, **_same_start(args))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert [s for _, s in _steps(lines).values()] == \
        [s for _, s in _steps(ref_lines).values()] == \
        ["wire fwd 32,768B + bwd 32,768B /step"] * 3
    assert _totals(lines) == _totals(ref_lines)
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    if not cfg.frontend:
        assert seen == {"ref": None, "port": None}
        return
    fe, ref_fe = seen["port"], seen["ref"]
    assert tuple(fe.shape) == tuple(ref_fe.shape) == (8, cfg.frontend_seq,
                                                      cfg.frontend_dim)
    assert fe.dtype == torch.float32 and str(ref_fe.dtype) == "float32"
    assert fe.device.type == "cpu" and not fe.any()


def test_vlm_with_a_codec_raises_in_both_packages():
    """ROADMAP.md C7, shared by both packages: each run_standard makes the codec
    at D = seq * d_model, but a VLM's cut carries the frontend positions
    too, (frontend_seq + seq) * d_model, so reduced pixtral-12b (8 + 8
    positions of 256) cannot train with a codec through run_standard.
    The port keeps the reference's behaviour."""
    args = _args("--steps", "1", "--arch", "pixtral-12b", "--codec", "c3sl:R=4")
    for pkg in ("ref", "port"):
        with pytest.raises(ValueError, match="feature dim 4096 != codec D=2048"):
            _run(pkg, args)


def test_adaptive_schedule_walks_and_matches_reference():
    """The Adaptive-R controller walks the ladder over eight steps (more
    than one bucket serves), and the served schedule is the reference's."""
    args = _args("--steps", "8", "--codec",
                 "adaptive:c3sl:R=8,min_R=2,target_snr=-6,ema=0.5")
    _, ref_lines = _run("ref", args)
    _, lines = _run("port", args, **_same_start(args))
    served = [re.search(r"R=(\d+)", s).group(1) for _, s in _steps(lines).values()]
    assert served == [re.search(r"R=(\d+)", s).group(1)
                      for _, s in _steps(ref_lines).values()]
    assert len(set(served)) > 1, served


def test_cli_prints_the_reference_lines():
    """``--reduced --steps 2 --device cpu --codec "c3sl:R=4|int8"`` at the
    CLI's default batch and sequence: the same arch line, per-step wire
    bytes and boundary-traffic total as the reference CLI's."""
    argv = ["--reduced", "--steps", "2", "--codec", "c3sl:R=4|int8"]
    outs = {}
    for name, main in (("ref", jtrain.main), ("port", ttrain.main)):
        out = io.StringIO()
        extra = ["--device", "cpu"] if name == "port" else []
        old = sys.argv
        sys.argv = ["train", *argv, *extra]
        try:
            with contextlib.redirect_stdout(out):
                main() if name == "ref" else main(argv + extra)
        finally:
            sys.argv = old
        outs[name] = out.getvalue().splitlines()
    assert outs["port"][0] == outs["ref"][0]          # arch=... params=...
    wire = lambda ls: [re.search(r"wire .*?/step", ln).group(0)  # noqa: E731
                       for ln in ls if ln.startswith("step")]
    assert wire(outs["port"]) == wire(outs["ref"]) == \
        ["wire fwd 131,088B + bwd 131,088B /step"] * 2
    assert _totals(outs["port"]) == _totals(outs["ref"])
    assert outs["port"][-1].startswith("final loss")


@pytest.mark.parametrize("flags", [["--sanitize"]])
def test_unported_flags_raise(flags, capsys):
    """What this test pinned as refused is ported now: ``--sanitize`` arms
    the train loop's sanitizers, prints the line naming them, leaves the
    log lines of an unarmed run as they were, and turns autograd's anomaly
    mode off again when the run returns."""
    argv = ["--reduced", "--steps", "1", "--device", "cpu", "--log-every", "1"]
    outs = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)      # the same sums in the same order, both runs
    try:
        for armed in (False, True):
            ttrain.main(argv + (flags if armed else []))
            outs[armed] = capsys.readouterr().out.splitlines()
    finally:
        torch.set_num_threads(n)
    assert not torch.is_anomaly_enabled()
    assert outs[True][1] == ("[sanitize] autograd anomaly mode (check_nan) + "
                             "finite step outputs + per-step finite checks armed")
    strip = lambda ls: [re.sub(r"\|.*", "", ln) for ln in ls]  # noqa: E731
    assert strip(outs[True][:1] + outs[True][2:]) == strip(outs[False])


@pytest.mark.parametrize("seed,steps", [(0, (0, 1, 5)), (3, (2,))])
def test_token_dataset_equals_reference(seed, steps):
    jd = jdata.SyntheticTokenDataset(512, 16, seed=seed)
    td = tdata.SyntheticTokenDataset(512, 16, seed=seed)
    np.testing.assert_array_equal(td.successor, jd.successor)
    for step in steps:
        want, got = jd.batch(4, step), td.batch(4, step, device="cpu")
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    it = tdata.make_batch_iterator(td, 4, start_step=1, device="cpu")
    jit_ = jdata.make_batch_iterator(jd, 4, start_step=1)
    for _ in range(2):
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      np.asarray(next(jit_)["tokens"]))


# ---------------------------------------------------------------------------
# checkpoints, across the two packages
# ---------------------------------------------------------------------------

def _trees():
    cfg_j = jconfigs.reduced(jconfigs.get_config("deepseek-7b"))
    cfg_t = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    pj = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(2), cfg_j))
    tree_np = {"params": pj, "step": np.int32(3), "list": [np.ones(2, np.float32)]}
    tree_t = params_from_numpy(tree_np, device="cpu")
    template_t = {"params": tlm.init_lm_params(0, cfg_t, device="cpu"),
                  "step": torch.zeros((), dtype=torch.int32),
                  "list": [torch.zeros(2)]}
    return tree_np, tree_t, template_t


def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    tree_np, tree_t, _ = _trees()
    out = tckpt.save_checkpoint(str(tmp_path), 7, tree_t, {"arch": "x"})
    assert out.endswith("step_00000007")
    assert jckpt.latest_step(str(tmp_path)) == tckpt.latest_step(str(tmp_path)) == 7
    template = jax.tree.map(lambda a: jax.numpy.zeros_like(a), tree_np)
    got = jckpt.restore_checkpoint(str(tmp_path), 7, template)
    assert jax.tree.structure(got) == jax.tree.structure(template)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree_np)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path):
    tree_np, _, template_t = _trees()
    jckpt.save_checkpoint(str(tmp_path), 2, tree_np, {"arch": "x"})
    got = tckpt.restore_checkpoint(str(tmp_path), 2, template_t)
    assert list(got) == sorted(template_t)
    want = jax.tree.leaves(tree_np)
    leaves = tree_leaves(got)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    # the manifests list the same keys
    import json
    tckpt.save_checkpoint(str(tmp_path / "port"), 2, got)
    keys = lambda d: json.load(open(d / "step_00000002" / "manifest.json"))["keys"]  # noqa: E731
    assert keys(tmp_path / "port") == keys(tmp_path)


def test_restore_errors_match_reference(tmp_path):
    tree_np, tree_t, template_t = _trees()
    tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2, 3)})
    errs = []
    for restore, template in (
            (jckpt.restore_checkpoint, {"w": jax.numpy.zeros((3, 2))}),
            (tckpt.restore_checkpoint, {"w": torch.zeros(3, 2)})):
        with pytest.raises(ValueError) as e:
            restore(str(tmp_path), 1, template)
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "w: shape (2, 3) != template (3, 2)"
    with pytest.raises(KeyError, match="checkpoint missing v"):
        tckpt.restore_checkpoint(str(tmp_path), 1, {"v": torch.zeros(1)})
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def test_run_standard_writes_a_checkpoint_the_reference_restores(tmp_path):
    """``--ckpt-dir``: the final params, under ``params/...`` at the step
    count, restore through the reference bitwise."""
    args = _args("--steps", "2", "--codec", "c3sl:R=2", "--ckpt-dir",
                 str(tmp_path))
    out = {}
    ttrain.run_standard(args, tconfigs.reduced(tconfigs.get_config(args.arch)),
                        out=out)
    cfg_j = jconfigs.reduced(jconfigs.get_config(args.arch))
    template = {"params": jlm.abstract_params(cfg_j)}
    template = jax.tree.map(lambda s: jax.numpy.zeros(s.shape, s.dtype), template)
    got = jckpt.restore_checkpoint(str(tmp_path), 2, template)
    for a, b in zip(jax.tree.leaves(got), tree_leaves(out["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("opt_name", ["adamw", "adam"])
def test_in_place_update_equals_the_functional_one(opt_name):
    """``clip_by_global_norm_`` and ``opt.update_`` (the trainer's step)
    give the params and state of ``clip_by_global_norm``, ``opt.update``
    and ``apply_updates`` bit for bit, over four steps."""
    from repro_torch import optim
    from repro_torch.interop import tree_map
    rng = np.random.default_rng(1)
    params = {"a": torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)),
              "b": [torch.from_numpy(rng.normal(size=3).astype(np.float32))]}
    opt = getattr(optim, opt_name)(1e-2)
    pf, pi = (tree_map(lambda t: t.clone(), params) for _ in range(2))
    sf, si = opt.init(pf), opt.init(pi)
    for _ in range(4):
        g = tree_map(lambda t: torch.from_numpy(
            3 * rng.normal(size=t.shape).astype(np.float32)), params)
        gi = tree_map(lambda t: t.clone(), g)
        gc, gn = optim.clip_by_global_norm(g, 1.0)
        assert torch.equal(optim.clip_by_global_norm_(gi, 1.0), gn)
        updates, sf = opt.update(gc, sf, pf)
        pf = optim.apply_updates(pf, updates)
        opt.update_(gi, si, pi)
    for a, b in zip(tree_leaves((pf, sf)), tree_leaves((pi, si))):
        assert torch.equal(a, b)
