"""repro_torch.analysis, the static half: rules R1-R3 read for PyTorch
(a fixture positive and negative per sub-rule, the pre-fix and fixed
``masked_write`` of ROADMAP C9, the engine's two windows), R4 and R5 exact
against the reference's on every fixture of ``tests/test_analysis.py`` and
on ``src/`` and ``tests/``, suppression, the baseline and the CLI as the
reference's tests check them, self-application against
``analysis-baseline-torch.json``, the gate with torch, jax and ``repro``
unimportable, and ``chip_smoke.py`` phase 20's mapping from recorded sync
warnings to lint sites (the audit itself needs the card)."""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro.analysis import baseline as jbaseline
from repro_torch.analysis import (BASELINE_NAME, diff_against_baseline,
                                  lint_paths, lint_source, load_baseline,
                                  write_baseline)
from repro_torch.analysis.__main__ import main

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def hits(source: str, rule: str):
    report = lint_source(textwrap.dedent(source))
    assert not report.errors, report.errors
    return [f for f in report.findings if f.rule == rule]


def loop(body: str) -> str:
    """``body`` (one statement per line) inside a step loop: a loop that
    dispatches a program-table entry."""
    inner = textwrap.indent(textwrap.dedent(body).strip(), " " * 8)
    return (f"import numpy as np\nimport torch\nfrom repro_torch import codecs\n"
            f"table = codecs.build_program_table(c, p, make)\n"
            f"def run(steps, x, state, dev):\n"
            f"    for i in range(steps):\n"
            f"        x = table[None](x)\n{inner}\n")


# ---------------------------------------------------------------------------
# R1: recompile and rebuild hazards
# ---------------------------------------------------------------------------

R1_CASES = {
    "compile_in_loop": ("""
        import torch
        def train(steps, f, x):
            for i in range(steps):
                step = torch.compile(f)
                step(x)
    """, 1),
    "jit_script_in_loop": ("""
        import torch
        def train(steps, f):
            for i in range(steps):
                g = torch.jit.script(f)
    """, 1),
    "jit_trace_in_while": ("""
        from torch import jit
        def train(f, x):
            while x:
                g = jit.trace(f, x)
    """, 1),
    "cuda_graph_in_loop": ("""
        import torch
        def capture(steps):
            for i in range(steps):
                g = torch.cuda.CUDAGraph()
    """, 1),
    "compile_lambda_invoked": ("""
        import torch
        def f(x):
            return torch.compile(lambda y: y * 2)(x)
    """, 1),
    "program_table_in_loop": ("""
        from repro_torch import codecs, transport
        def serve(reqs, c, p, make):
            for r in reqs:
                table = codecs.build_program_table(c, p, make)
                links = transport.build_link_program_table(c, p, make)
    """, 2),
    "extension_load_in_loop": ("""
        from torch.utils import cpp_extension
        from torch.utils.cpp_extension import load_inline
        def build(names):
            for n in names:
                cpp_extension.load(n, [n + ".cu"])
                load_inline(n, "", "")
    """, 2),
    # negatives: made once, dispatched in the loop
    "hoisted_compile_and_table": ("""
        import torch
        from repro_torch import codecs
        def build(c, p, make, f, x):
            table = codecs.build_program_table(c, p, make)
            step = torch.compile(f)
            g = torch.cuda.CUDAGraph()
            for key in (2, 4):
                table[key](key)
                step(x)
                g.replay()
            return table, step
    """, 0),
    "compile_named_function_once": ("""
        import torch
        def body(y):
            return y * 2
        fast = torch.compile(body)
        def f(x):
            return fast(x)
    """, 0),
    "compile_outside_function_scope": ("""
        import torch
        def build(f):
            return torch.compile(f)
        for name in ("a", "b"):
            pass
    """, 0),
    "extension_loaded_once": ("""
        from torch.utils.cpp_extension import load
        mod = load("k", ["k.cu"])
        def run(xs):
            for x in xs:
                mod.run(x)
    """, 0),
}


@pytest.mark.parametrize("case", list(R1_CASES))
def test_r1(case):
    source, n = R1_CASES[case]
    found = hits(source, "R1")
    assert len(found) == n, [str(f) for f in found]
    if case == "compile_lambda_invoked":
        assert "lambda" in found[0].message
    elif n:
        assert all("loop" in f.message for f in found)


# ---------------------------------------------------------------------------
# R2: stale aliases across an in-place write
# ---------------------------------------------------------------------------

R2_CASES = {
    "view_read_after_copy_": ("""
        def step(cache, new):
            row = cache[0]
            cache.copy_(new)
            return row.sum()
    """, 1),
    "method_view_after_index_copy_": ("""
        def step(pool, idx, vals):
            flat = pool.view(-1, 4)
            pool.index_copy_(0, idx, vals)
            return flat
    """, 1),
    "alias_itself_after_add_": ("""
        def step(x):
            before = x
            x.add_(1)
            return before
    """, 1),
    "subscript_store_write": ("""
        def step(cache, i, v):
            old = cache[i].detach()
            cache[i] = v
            return old
    """, 1),
    "out_keyword_write": ("""
        import torch
        def step(a, b, acc):
            snap = acc.reshape(-1)
            torch.add(a, b, out=acc)
            return snap
    """, 1),
    "write_through_a_view_of_the_base": ("""
        def step(cache, new):
            k = cache[0]
            cache[1].zero_()
            return k
    """, 1),
    # negatives
    "clone_is_a_snapshot": ("""
        def step(cache, new):
            row = cache[0].clone()
            cache.copy_(new)
            return row.sum()
    """, 0),
    "rebound_after_the_write": ("""
        def step(cache, new):
            row = cache[0]
            cache.copy_(new)
            row = cache[0]
            return row.sum()
    """, 0),
    "read_before_the_write": ("""
        def step(cache, new):
            row = cache[0]
            total = row.sum()
            cache.copy_(new)
            return total
    """, 0),
    "string_key_is_a_container_lookup": ("""
        def step(cache, table):
            pages = cache["pages"]
            cache["pages"] = table
            return pages
    """, 0),
    "write_into_the_alias_not_the_base": ("""
        def step(cache, new):
            row = cache[0]
            other = new[0]
            other.zero_()
            return row
    """, 0),
}


@pytest.mark.parametrize("case", list(R2_CASES))
def test_r2(case):
    source, n = R2_CASES[case]
    found = hits(source, "R2")
    assert len(found) == n, [str(f) for f in found]
    if n:
        assert "in-place write" in found[0].message


# ---------------------------------------------------------------------------
# R3 (a): the sync constructs, each in a step loop and, clean, beside it
# ---------------------------------------------------------------------------

R3_CONSTRUCTS = {
    "item": ("v = x.item()", "v = x"),
    "tolist": ("v = x.tolist()", "v = x.clone()"),
    "cpu": ("v = x.cpu()", "v = x.cuda(non_blocking=True)"),
    "numpy": ("v = x.numpy()", "v = x.contiguous()"),
    "to_cpu": ("v = x.to('cpu')", "v = x.to(torch.float32)"),
    "to_device_cpu": ("v = x.to(device='cpu')", "v = x.to(dev)"),
    "to_torch_device_cpu": ("v = x.to(torch.device('cpu'))", "v = x.to(x.dtype)"),
    "float": ("v = float(x)", "v = float(3)"),
    "int": ("v = int(x.sum())", "v = int(3)"),
    "bool": ("v = bool(x.any())", "v = x.any()"),
    "synchronize": ("torch.cuda.synchronize()", "torch.cuda.current_stream()"),
    "equal": ("v = torch.equal(x, x)", "v = torch.eq(x, x)"),
    "allclose": ("v = torch.allclose(x, x)", "v = torch.isclose(x, x)"),
    "nonzero_method": ("v = x.nonzero()", "v = x.count_nonzero()"),
    "nonzero_call": ("v = torch.nonzero(x)", "v = torch.count_nonzero(x)"),
    "where_one_arg": ("v = torch.where(x > 0)", "v = torch.where(x > 0, x, 0)"),
    "if_any": ("if x.any():\n    x = x + 1", "x = torch.where(x.any(), x + 1, x)"),
    "while_not_all": ("while not (x > 0).all():\n    x = x + 1",
                      "while x.dim() < 2:\n    x = x[None]"),
    "host_to_device_to": ("v = torch.from_numpy(a).to(dev)",
                          "v = torch.from_numpy(a)"),
    "host_to_device_cuda": ("v = torch.from_numpy(a).cuda()", "v = x.cuda()"),
    "tensor_on_device": ("v = torch.tensor([1, 2], device=dev)",
                         "v = torch.tensor([1, 2])"),
    "as_tensor_on_device": ("v = torch.as_tensor(rows, device=dev)",
                            "v = torch.as_tensor(rows, device='cpu')"),
}


@pytest.mark.parametrize("name", list(R3_CONSTRUCTS))
@pytest.mark.parametrize("flagged", [True, False], ids=["construct", "clean"])
def test_r3_constructs_in_a_step_loop(name, flagged):
    bad, good = R3_CONSTRUCTS[name]
    found = hits(loop(bad if flagged else good), "R3")
    assert len(found) == int(flagged), [str(f) for f in found]
    if flagged:
        assert "step loop" in found[0].message


def test_r3_constructs_outside_any_step_loop_are_clean():
    body = "\n".join(bad for bad, _ in R3_CONSTRUCTS.values())
    plain = ("import numpy as np\nimport torch\n"
             "def host(items, x, a, rows, dev):\n    for i in items:\n"
             + textwrap.indent(body, " " * 8) + "\n")
    assert hits(plain, "R3") == []


# ---------------------------------------------------------------------------
# R3 (b): captured or compiled bodies
# ---------------------------------------------------------------------------

R3_CAPTURED = {
    "cuda_graph_block": ("""
        import torch
        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                n = y.item()
            return n
    """, 1),
    "make_graphed_callables": ("""
        import torch
        def body(x):
            return x.tolist()
        fn = torch.cuda.make_graphed_callables(body, (x0,))
    """, 1),
    "compiled_by_call": ("""
        import torch
        def body(x):
            if x.any():
                return x
            return -x
        fast = torch.compile(body)
    """, 1),
    "compiled_by_decorator": ("""
        import torch
        @torch.compile(fullgraph=True)
        def body(x):
            return float(x.sum())
    """, 1),
    # negatives
    "sync_after_the_capture": ("""
        import torch
        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
            return y.item()
    """, 0),
    "plain_function": ("""
        import torch
        def body(x):
            return x.tolist()
    """, 0),
}


@pytest.mark.parametrize("case", list(R3_CAPTURED))
def test_r3_captured_and_compiled_bodies(case):
    source, n = R3_CAPTURED[case]
    found = hits(source, "R3")
    assert len(found) == n, [str(f) for f in found]
    if n:
        assert "capture" in found[0].message or "compile" in found[0].message


# ---------------------------------------------------------------------------
# R3 (c): what makes a step loop, and what runs once per iteration
# ---------------------------------------------------------------------------

R3_LOOPS = {
    "program_table_entry": ("""
        from repro_torch import transport
        step_fns = transport.build_link_program_table(c, p, make)
        def train(steps, params, batch):
            losses = []
            for step in range(steps):
                params, loss = step_fns[key](params, batch)
                losses.append(float(loss))
            return losses
    """, 1),
    "compiled_name": ("""
        import torch
        step = torch.compile(body)
        def train(steps, x):
            for i in range(steps):
                x = step(x)
                print(x.item())
    """, 1),
    "graph_replay": ("""
        def serve(g, flags, n):
            for i in range(n):
                g.replay()
                if flags.any():
                    break
    """, 1),
    "local_step_function": ("""
        from repro_torch.models import lm as lm_lib
        def make(params, cache, cfg):
            def step_fn(state):
                return lm_lib.decode_step(params, cache, state, cfg)
            def window(state, n):
                for i in range(n):
                    state = step_fn(state)
                    if not bool(state.any()):
                        break
                return state
            return window
    """, 1),
    "step_maker": ("""
        from repro_torch.transport import split
        def train(loss, opt, batches, params, state):
            step = split.make_split_train_step(loss, opt)
            for b in batches:
                params, state, l = step(params, state, b)
                print(l.tolist())
    """, 1),
    "reached_helper": ("""
        class Engine:
            def run(self):
                while self.busy:
                    self.tick()
            def tick(self):
                self._programs[None]["window"](self.state)
                self._read()
            def _read(self):
                return {k: v.cpu() for k, v in self.state.items()}
            def __init__(self, c, p):
                self._programs = codecs.build_program_table(c, p, self._make)
    """, 1),
    "table_entry_body": ("""
        class Engine:
            def __init__(self):
                self._spec = {}
                self._spec[4] = self._make_spec(4)
            def _make_spec(self, k):
                def spec_window(state, n):
                    totals = state.sum()
                    return totals.tolist()
                return spec_window
            def run(self):
                while self.queue:
                    self._spec[4](self.state, 2)
    """, 1),
    # negatives
    "loop_without_a_step": ("""
        def accumulate(items):
            total = 0.0
            for x in items:
                total += float(x)
            return total
    """, 0),
    "deferred_conversion": ("""
        import torch
        step = torch.compile(body)
        def train(steps, params, batch):
            losses = []
            for i in range(steps):
                params, loss = step(params, batch)
                losses.append(loss)
            return [float(l) for l in losses]
    """, 0),
    "helper_not_called_from_the_loop": ("""
        class Engine:
            def run(self):
                while self.busy:
                    self._programs[None]["window"](self.state)
            def report(self):
                return self.state["out"].tolist()
            def __init__(self, c, p):
                self._programs = codecs.build_program_table(c, p, self._make)
    """, 0),
}


@pytest.mark.parametrize("case", list(R3_LOOPS))
def test_r3_step_loops(case):
    source, n = R3_LOOPS[case]
    found = hits(source, "R3")
    assert len(found) == n, [str(f) for f in found]


# ---------------------------------------------------------------------------
# R3 (d): a 0-dim device index — ROADMAP C9's masked_write, before and after
# ---------------------------------------------------------------------------

MASKED_WRITE_PRE_FIX = """
import torch

def masked_write(rows, idx, vals, keep):
    any_keep = keep.any()
    first = torch.argmax(keep.to(torch.int32))
    lead = (-1,) + (1,) * (vals.ndim - 1)
    use_first = (~keep & any_keep).reshape(lead)
    tgt = torch.where(keep | ~any_keep, idx, idx[first])
    src = torch.where(use_first, vals[first].unsqueeze(0),
                      torch.where(keep.reshape(lead), vals, rows[idx]))
    rows[tgt] = src.to(rows.dtype)
"""

MASKED_WRITE_FIXED = """
import torch

def masked_write(rows, idx, vals, keep):
    any_keep = keep.any()
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    lead = (-1,) + (1,) * (vals.ndim - 1)
    use_first = (~keep & any_keep).reshape(lead)
    tgt = torch.where(keep | ~any_keep, idx, idx.index_select(0, first))
    src = torch.where(use_first, vals.index_select(0, first),
                      torch.where(keep.reshape(lead), vals, rows[idx]))
    rows[tgt] = src.to(rows.dtype)
"""

R3_INDEX = {
    "masked_write_pre_fix": (MASKED_WRITE_PRE_FIX, 2),
    "argmin_method": ("""
        def pick(x, table):
            j = x.argmin()
            return table[j, 0]
    """, 1),
    "masked_write_fixed": (MASKED_WRITE_FIXED, 0),
    "argmax_with_dim": ("""
        import torch
        def pick(logits, table):
            j = torch.argmax(logits, dim=-1)
            k = logits.argmax(-1) if False else logits.argmax(dim=0)
            return table[j], table[k]
    """, 0),
}


@pytest.mark.parametrize("case", list(R3_INDEX))
def test_r3_zero_dim_index(case):
    source, n = R3_INDEX[case]
    found = hits(source, "R3")
    assert len(found) == n, [str(f) for f in found]
    if case == "masked_write_pre_fix":
        assert [f.code for f in found] == [
            "tgt = torch.where(keep | ~any_keep, idx, idx[first])",
            "src = torch.where(use_first, vals[first].unsqueeze(0),"]
        assert all("0-dim" in f.message for f in found)


def test_reference_r3_misses_what_the_port_flags():
    """C9's pre-fix ``masked_write`` and the engine's window reads: the
    reference's R3 flags none of them, the port's flags each."""
    engine = (ROOT / "src/repro_torch/serving/engine.py").read_text()
    for src in (textwrap.dedent(MASKED_WRITE_PRE_FIX), engine):
        assert [f for f in jlint.lint_source(src, rules={"R3"}).findings] == []
        assert [f for f in jlint.lint_source(src, rules={"R3"}).suppressed] == []


ENGINE_READS = {
    # the decode window's live/done flags, once a step
    "window_flags": "live_any, done_any = torch.stack(",
    # the speculative window: any slot live, once a round; its totals
    "spec_live": 'if not bool((state["active"] & ~state["done"]).any()):',
    "spec_totals": "acc, rej, rol = totals.tolist()",
}


@pytest.mark.parametrize("read", list(ENGINE_READS))
def test_r3_flags_the_engine_window_reads_with_a_b6_rationale(read):
    path = "src/repro_torch/serving/engine.py"
    report = lint_paths([ROOT / path], rules={"R3"}, root=ROOT)
    got = [f for f in report.suppressed if f.code.startswith(ENGINE_READS[read])]
    assert len(got) == 1 and "B6" in got[0].reason, [str(f) for f in got]
    assert not report.findings


# ---------------------------------------------------------------------------
# R4 and R5: exact against the reference's
# ---------------------------------------------------------------------------

def _reference_fixtures() -> dict:
    """Every fixture source of tests/test_analysis.py's R4, R5,
    suppression, baseline and syntax-error tests."""
    tree = ast.parse((ROOT / "tests/test_analysis.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not any(
                k in fn.name for k in ("_r4", "_r5", "suppress", "baseline",
                                       "syntax")):
            continue
        n = 0
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out[f"{fn.name}[{n}]"] = textwrap.dedent(node.args[0].value)
                n += 1
    return out


REF_FIXTURES = _reference_fixtures()


def _rows(found):
    return [(f.rule, f.path, f.line, f.col, f.code, f.reason) for f in found]


@pytest.mark.parametrize("name", list(REF_FIXTURES))
def test_r4_r5_equal_reference_on_its_fixtures(name):
    src = REF_FIXTURES[name]
    ours = lint_source(src, path="pkg/mod.py", rules={"R4", "R5"})
    ref = jlint.lint_source(src, path="pkg/mod.py", rules={"R4", "R5"})
    assert _rows(ours.findings) == _rows(ref.findings)
    assert _rows(ours.suppressed) == _rows(ref.suppressed)
    assert bool(ours.errors) == bool(ref.errors)


def test_reference_fixtures_were_found():
    assert len(REF_FIXTURES) >= 17
    assert sum("_r4_" in k for k in REF_FIXTURES) == 4
    assert sum("_r5" in k for k in REF_FIXTURES) == 8


def test_r4_r5_equal_reference_over_src_and_tests():
    """Both packages' ``lint_paths`` over every file of ``src/`` and
    ``tests/`` that R4 or R5 can fire on in either package: R4 needs a
    ``register`` decorator, R5 an ``async def`` or a ``create_task`` /
    ``ensure_future`` call, so a file without those words has no R4 or R5
    finding in either (leaving them out halves the reference's 8 s)."""
    paths = [f for f in jlint.iter_py_files([ROOT / "src", ROOT / "tests"])
             if re.search(r"register|async|create_task|ensure_future",
                          f.read_text(encoding="utf-8"))]
    assert len(paths) > 40
    ours = lint_paths(paths, rules={"R4", "R5"}, root=ROOT)
    ref = jlint.lint_paths(paths, rules={"R4", "R5"}, root=ROOT)
    assert ours.suppressed and _rows(ours.suppressed) == _rows(ref.suppressed)
    assert _rows(ours.findings) == _rows(ref.findings)
    # where the message names no JAX, HLO or XLA, it is the reference's
    for a, b in zip(ours.findings + ours.suppressed, ref.findings + ref.suppressed):
        if a.rule == "R5":
            assert a.message == b.message


# ---------------------------------------------------------------------------
# suppression, baseline, syntax errors (as tests/test_analysis.py checks the
# reference)
# ---------------------------------------------------------------------------

BLOCKING = """
    import asyncio, time
    async def handler():
        time.sleep(1.0)  {pragma}
"""


@pytest.mark.parametrize("pragma,findings,suppressed,reason", [
    ("# lint-ok: R5 measured: sub-ms on this path", 0, 1,
     "measured: sub-ms on this path"),
    ("# lint-ok: R3 wrong rule id", 1, 0, None),
    ("# lint-ok: R3, R5 both quiet", 0, 1, "both quiet"),
    ("# lint-ok:R1,R5", 0, 1, ""),
], ids=["suppressed_with_reason", "rule_specific", "multi_rule", "no_reason"])
def test_suppression(pragma, findings, suppressed, reason):
    report = lint_source(textwrap.dedent(BLOCKING.format(pragma=pragma)))
    assert len(report.findings) == findings and len(report.suppressed) == suppressed
    if reason is not None:
        assert report.suppressed[0].reason == reason


def test_multi_rule_pragma_clears_two_rules_on_one_line():
    src = textwrap.dedent("""
        import asyncio, time, torch
        from repro_torch import codecs
        table = codecs.build_program_table(c, p, make)
        async def handler(x):
            for i in range(3):
                table[None](x)
                time.sleep(float(x))  # lint-ok: R3, R5 both rules, one comment
    """)
    report = lint_source(src)
    assert report.findings == []
    assert sorted(f.rule for f in report.suppressed) == ["R3", "R5"]


def test_baseline_roundtrip_and_diffing(tmp_path):
    src = textwrap.dedent("""
        import asyncio
        def spawn(coro):
            asyncio.create_task(coro)
    """)
    report = lint_source(src, path="pkg/mod.py")
    assert len(report.findings) == 1
    bl = tmp_path / BASELINE_NAME
    write_baseline(report, bl)
    new, fixed = diff_against_baseline(report, load_baseline(bl))
    assert new == [] and not fixed
    # moved lines: the fingerprint still matches
    moved = lint_source("\n\n\n" + src, path="pkg/mod.py")
    new, fixed = diff_against_baseline(moved, load_baseline(bl))
    assert new == [] and not fixed
    # a second violation of the same rule is new
    grown = lint_source(src + textwrap.dedent("""
        def spawn2(coro):
            asyncio.ensure_future(coro)
    """), path="pkg/mod.py")
    new, _ = diff_against_baseline(grown, load_baseline(bl))
    assert len(new) == 1 and "ensure_future" in new[0].code
    # fixed: reported as stale
    clean = lint_source("x = 1\n", path="pkg/mod.py")
    new, fixed = diff_against_baseline(clean, load_baseline(bl))
    assert new == [] and sum(fixed.values()) == 1


def test_syntax_error_is_reported_not_raised():
    report = lint_source("def broken(:\n")
    assert report.errors and report.findings == []


def test_baseline_name_is_the_ports_own():
    assert BASELINE_NAME == "analysis-baseline-torch.json"
    assert BASELINE_NAME != jbaseline.BASELINE_NAME


def test_write_baseline_equals_the_reference_writer(tmp_path):
    src = textwrap.dedent("""
        import asyncio, time
        def spawn(coro):
            asyncio.create_task(coro)
        async def worker(task):
            time.sleep(0.1)  # lint-ok: R5 a test's pause
            try:
                await task
            except asyncio.CancelledError:
                pass
    """)
    ours = lint_source(src, path="pkg/mod.py", rules={"R5"})
    ref = jlint.lint_source(src, path="pkg/mod.py", rules={"R5"})
    write_baseline(ours, tmp_path / "ours.json")
    jbaseline.write_baseline(ref, tmp_path / "ref.json")
    a, b = (json.loads((tmp_path / n).read_text()) for n in ("ours.json",
                                                             "ref.json"))
    assert len(a["findings"]) == 2 and len(a["suppressed"]) == 1
    assert a["findings"] == b["findings"] and a["suppressed"] == b["suppressed"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def tree(tmp_path):
    """A root with a .git marker and one clean module."""
    (tmp_path / ".git").mkdir()
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "ok.py").write_text("x = 1\n")
    return tmp_path


def _bad(tree):
    (tree / "pkg" / "bad.py").write_text(
        "import asyncio\ndef spawn(c):\n    asyncio.create_task(c)\n")


@pytest.mark.parametrize("setup,argv,code", [
    (None, ["--check"], 0),
    (None, [], 0),
    ("bad", ["--check"], 1),
    ("bad", [], 1),
    ("bad", ["--rules", "R3"], 0),
    ("bad_baselined", ["--check"], 0),
    ("syntax", ["--check"], 1),
    ("syntax", ["--write-baseline"], 1),
], ids=["check_clean", "report_clean", "check_new", "report_finding",
        "rules_subset", "check_baselined", "check_syntax", "write_syntax"])
def test_cli_exit_codes(tree, capsys, setup, argv, code):
    if setup in ("bad", "bad_baselined"):
        _bad(tree)
    if setup == "bad_baselined":
        assert main(["--write-baseline", str(tree / "pkg")]) == 0
        assert (tree / BASELINE_NAME).exists()
        assert not (tree / jbaseline.BASELINE_NAME).exists()
    if setup == "syntax":
        (tree / "pkg" / "broken.py").write_text("def f(:\n")
    assert main([*argv, str(tree / "pkg")]) == code
    out = capsys.readouterr().out
    if "--check" in argv:
        assert "new finding(s) vs baseline" in out


def test_cli_baseline_flag_and_show_suppressed(tree, capsys):
    (tree / "pkg" / "s.py").write_text(
        "import asyncio\ndef spawn(c):\n"
        "    asyncio.create_task(c)  # lint-ok: R5 kept by the caller\n")
    other = tree / "elsewhere.json"
    assert main(["--write-baseline", "--baseline", str(other),
                 str(tree / "pkg")]) == 0
    data = json.loads(other.read_text())
    assert data["findings"] == [] and len(data["suppressed"]) == 1
    assert not (tree / BASELINE_NAME).exists()
    assert main(["--show-suppressed", str(tree / "pkg")]) == 0
    assert "SUPPRESSED (kept by the caller)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# self-application: the port lints clean against its committed baseline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    return lint_paths([ROOT / "src" / "repro_torch"], root=ROOT)


def test_port_is_clean_against_its_committed_baseline(port_report):
    report = port_report
    assert not report.errors, report.errors
    new, _ = diff_against_baseline(report, load_baseline(ROOT / BASELINE_NAME))
    assert new == [], "new lint findings:\n" + "\n".join(map(str, new))


def test_committed_port_baseline_has_no_findings_and_records_suppressions(
        port_report):
    data = json.loads((ROOT / BASELINE_NAME).read_text())
    assert data["findings"] == []
    assert [(e["rule"], e["path"], e["code"]) for e in data["suppressed"]] == [
        f.fingerprint() for f in port_report.suppressed]


def test_cli_gate_passes_on_the_port_with_torch_jax_and_repro_unimportable():
    """``python -m repro_torch.analysis --check src/repro_torch``, in a
    process where torch, numpy, jax and the JAX package cannot be
    imported: exit 0, and none of them loaded."""
    block = ("import runpy, sys\n"
             "class Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro',"
             " 'numpy'):\n"
             "            raise ImportError(f'{name} is blocked')\n"
             "sys.meta_path.insert(0, Block())\n"
             "sys.argv = ['repro_torch.analysis', '--check', 'src/repro_torch']\n"
             "try:\n"
             "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    code = e.code\n"
             "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
             "('torch', 'jax', 'repro', 'numpy'))\n"
             "print('exit', code, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", block], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("exit 0 []"), out.stdout


# ---------------------------------------------------------------------------
# chip_smoke.py phase 20: recorded sync warnings mapped to lint sites
# ---------------------------------------------------------------------------

AUDITED = "src/repro_torch/serving/fake.py"
AUDITED_SRC = textwrap.dedent("""
    import torch
    from repro_torch import codecs
    table = codecs.build_program_table(c, p, make)
    def window(state, n):
        for i in range(n):
            state = table[None](state)
            live, done = torch.stack(
                [state.any(), state.all()]).tolist()
            flag = bool(state.any())  # lint-ok: R3 one read a step, by design
        return state
    def upload(a, dev):
        return torch.from_numpy(a).to(dev)
""").lstrip()
README = textwrap.dedent("""
    ## Something else
    | `src/repro_torch/serving/fake.py` | `return torch.from_numpy(a).to(dev)` | elsewhere |

    #### Sync sites no static rule sees
    | Site | Code | Why |
    | --- | --- | --- |
    | `src/repro_torch/serving/fake.py` | `return torch.from_numpy(a).to(dev)` | reached from another module |
    | `src/repro_torch/data/x.py` | `y = {"a": b \\| c}` | a pipe |
""")


def _frames(*sites):
    return [(AUDITED if p is None else p, ln, fn) for p, ln, fn in sites]


RECORDS = [
    # the flags' .tolist(): raised from the line of its method name
    {"frames": _frames((None, 8, "window"), ("src/repro_torch/x.py", 3, "tick")),
     "tag": 0},
    {"frames": _frames((None, 8, "window")), "tag": 1},
    {"frames": _frames((None, 9, "window")), "tag": 1},
    {"frames": _frames((None, 12, "upload")), "tag": 1},
    {"frames": _frames(("src/repro_torch/models/paging.py", 97, "masked_write"),
                       (None, 6, "window")), "tag": None},
    {"frames": [], "tag": 1},          # no port frame: the harness's own
]


def _read(path):
    return AUDITED_SRC if path == AUDITED else "x = 1\n"


def test_phase20_sites_and_counts():
    sites = chip_smoke.sync_sites(RECORDS)
    assert {k: v["count"] for k, v in sites.items()} == {
        f"{AUDITED}:8": 2, f"{AUDITED}:9": 1, f"{AUDITED}:12": 1,
        "src/repro_torch/models/paging.py:97": 1}
    assert sites[f"{AUDITED}:8"]["via"] == ["tick (x.py:3)"]
    steady = chip_smoke.sync_sites(RECORDS, lambda t: t == 1)
    assert sorted(steady) == [f"{AUDITED}:12", f"{AUDITED}:8", f"{AUDITED}:9"]


def test_phase20_verdicts_against_the_port_r3_report_and_the_readme():
    report = lint_source(AUDITED_SRC, path=AUDITED, rules={"R3"})
    assert [f.line for f in report.findings] == [7]
    assert [f.line for f in report.suppressed] == [9]
    spans = chip_smoke.r3_spans(report, _read)
    assert spans == {AUDITED: [(7, 8, "finding"), (9, 9, "suppressed")]}
    accepted = chip_smoke.accepted_sync_sites(README)
    assert accepted == {(AUDITED, "return torch.from_numpy(a).to(dev)"),
                        ("src/repro_torch/data/x.py", 'y = {"a": b | c}')}
    sites = chip_smoke.sync_sites(RECORDS)
    assert chip_smoke.sync_verdicts(sites, spans, accepted, _read) == {
        f"{AUDITED}:8": "R3 finding", f"{AUDITED}:9": "R3 suppressed",
        f"{AUDITED}:12": "README table",
        "src/repro_torch/models/paging.py:97": None}


def test_phase20_no_sync_functions():
    bad = chip_smoke.through_no_sync(RECORDS)
    assert len(bad) == 1 and bad[0]["frames"][0][2] == "masked_write"


def test_phase20_recorder_keeps_the_port_frames(monkeypatch):
    """The recorder's hook on a CPU torch (the debug mode stubbed): a
    warning raised from code compiled under a port file's name is kept with
    that frame innermost; other warnings pass through."""
    import torch
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    fake = str(ROOT / AUDITED)
    code = compile("def window(warn):\n    warn()\n", fake, "exec")
    ns = {}
    exec(code, ns)

    def sync():
        warnings.warn("called a synchronizing CUDA operation")

    with warnings.catch_warnings(record=True) as other:
        warnings.simplefilter("always")
        with chip_smoke.SyncRecorder(tag=lambda raw: len(raw) > 0) as rec:
            ns["window"](sync)
            ns["window"](sync)
            warnings.warn("something else")
    assert [r["frames"] for r in rec.records] == [[(AUDITED, 2, "window")]] * 2
    assert [r["tag"] for r in rec.records] == [True, True]
    assert [str(w.message) for w in other] == ["something else"]


def test_readme_accepted_table_parses():
    """The port README's table of sync sites no static rule sees: every row
    names a port file and a line of it that exists."""
    readme = (ROOT / "src/repro_torch/README.md").read_text()
    accepted = chip_smoke.accepted_sync_sites(readme)
    for path, code in accepted:
        lines = {ln.strip() for ln in (ROOT / path).read_text().splitlines()}
        assert path.startswith("src/repro_torch/") and code in lines, (path, code)
