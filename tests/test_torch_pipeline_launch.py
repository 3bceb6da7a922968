"""The port's pipeline CLI (``repro_torch.launch.train --pipeline``,
``run_pipeline``) held against the reference's.

The reference's ``run_pipeline`` needs an even device count, so its CLI
runs in one two-device subprocess for the module (as
``tests/test_pipeline_split.py`` runs it), at three codec specs and
``tests/test_pipeline_split.py``'s settings (reduced ``deepseek-7b``, batch
8, seq 16, R 2, 2 microbatches, depth 2): eight steps of ``c3sl``, and for
each other spec its lines without a step (``--steps 0``).  The port runs
the same flags on the CPU."""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_ATOL = 1.5e-4       # printed to 4 decimals: 5e-5 of rounding a side
# tests/test_pipeline_split.py's launcher settings
FLAGS = ["--reduced", "--batch", "8", "--seq", "16", "--R", "2",
         "--microbatches", "2", "--async-depth", "2", "--log-every", "1"]
SPECS = ["c3sl", "adaptive:c3sl:R=4,min_R=2 >> bwd:c3sl:R=2|int8", "none"]
TRAIN_STEPS = 8

REFERENCE = textwrap.dedent("""
    import contextlib, io, json, sys
    from repro.launch import train

    flags, specs, steps = json.loads(sys.argv[1])
    out = {}
    for i, spec in enumerate(specs):
        sys.argv = ["train", "--pipeline", "--steps", str(steps if i == 0 else 0),
                    "--codec", spec, *flags]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                train.main()
            except IndexError:
                # --steps 0 prints every line but the steps' and compiles
                # nothing; "final loss" then has no loss to report
                assert i > 0
        out[spec] = buf.getvalue().splitlines()
    print(json.dumps(out))
""")


def step_losses(lines):
    return [float(ln.split()[4]) for ln in lines if ln.startswith("[pipeline] step")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under the suite's parallel workers: one intra-op thread
    (as ``tests/test_torch_frontdoor.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps([FLAGS, SPECS, TRAIN_STEPS])],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def port_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain.main(argv)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("spec", SPECS)
def test_cli_lines_equal_the_reference(reference, spec):
    """The arch line, the adaptive link's pinned line and the channel line
    (``[pipeline] channel: async_depth=2, per-microbatch wire fwd ... B +
    bwd ... B``), character for character."""
    lines = port_main(["--pipeline", "--steps", "1", "--codec", spec,
                       "--device", "cpu", *FLAGS])
    ref = reference[spec]
    keep = [ln for ln in ref if not ln.startswith(("[pipeline] step", "final"))]
    assert [ln for ln in lines
            if not ln.startswith(("[pipeline] step", "final"))] == keep
    assert any(ln.startswith("[pipeline] channel: async_depth=2, ") for ln in keep)
    assert lines[-1].startswith("final loss")


def test_losses_from_the_reference_start_match(reference):
    """``run_pipeline`` from the reference CLI's start (the seed's
    ``init_lm_params`` and the keys of ``PRNGKey(7)``), eight steps: each
    loss as the CLI prints it (4 decimals) within 1.5e-4 of the
    reference's, its rounding and well under 1e-4 relative."""
    args = ttrain.build_parser().parse_args(
        ["--pipeline", "--steps", str(TRAIN_STEPS), "--codec", SPECS[0],
         "--device", "cpu", *FLAGS])
    jcfg = jconfigs.reduced(jconfigs.get_config(args.arch))
    full = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(args.seed),
                                                       jcfg))
    mb = args.batch // args.microbatches
    _, jkeys = jtrain.make_codec(args.codec, args.seq * jcfg.d_model, R=args.R,
                                 max_R=mb)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain.run_pipeline(
            args, tconfigs.reduced(tconfigs.get_config(args.arch)),
            params=params_from_numpy(full, "cpu"),
            codec_params=params_from_numpy(jax.tree.map(np.asarray, jkeys), "cpu"))
    got = step_losses(out.getvalue().splitlines())
    want = step_losses(reference[SPECS[0]])
    assert len(got) == len(want) == TRAIN_STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def test_port_cli_loss_falls():
    """The port's own seeded run at the reference test's settings: the
    loss falls over eight steps."""
    lines = port_main(["--pipeline", "--steps", str(TRAIN_STEPS), "--codec",
                       "c3sl", "--device", "cpu", *FLAGS])
    losses = step_losses(lines)
    assert len(losses) == TRAIN_STEPS and losses[-1] < losses[0], losses


@pytest.mark.parametrize("flag", ["--fault-drop", "--fault-corrupt"])
def test_fault_flags_refused_like_the_reference(flag):
    argv = ["--reduced", "--pipeline", "--steps", "1", flag, "0.1"]
    msgs = {}
    old = sys.argv
    try:
        for name, main, extra in (("ref", jtrain.main, []),
                                  ("port", ttrain.main, ["--device", "cpu"])):
            sys.argv = ["train", *argv, *extra]
            with pytest.raises(SystemExit) as e:
                main() if name == "ref" else main(argv + extra)
            msgs[name] = str(e.value)
    finally:
        sys.argv = old
    assert msgs["port"] == msgs["ref"]
    assert msgs["port"].startswith("fault injection drives the standard loop")


def test_pipeline_sanitize_still_raises(capsys):
    """What this test pinned as refused is ported now: ``--pipeline
    --sanitize`` arms the pipeline loop's sanitizers (the line naming
    them), gives the unarmed run's losses bitwise, checks every step, and
    leaves autograd's anomaly mode off after the run."""
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    argv = ["--reduced", "--pipeline", "--steps", "2", "--batch", "8",
            "--seq", "16", "--microbatches", "2", "--device", "cpu"]
    losses, out = {}, {}
    for armed in (False, True):
        args = ttrain.build_parser().parse_args(
            argv + (["--sanitize"] if armed else []))
        losses[armed] = ttrain.run_pipeline(args, cfg, out=out)
    assert not torch.is_anomaly_enabled()
    assert losses[True] == losses[False]
    assert out["train_sanitizer"].steps_checked == 2
    assert "[sanitize] autograd anomaly mode (check_nan)" in capsys.readouterr().out
