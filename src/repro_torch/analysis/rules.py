"""The port's lint rules R1-R5.

Port of ``repro/analysis/rules.py``: the same ids, the same checker shape
``(tree, source, path) -> iterable[(line, col, message)]`` registered in
:data:`CHECKERS`, each hazard read in PyTorch's terms.  The rules are
HEURISTIC — they encode this package's conventions (program tables made
once, caches written in place, a single-threaded asyncio front door), not
general Python semantics — and every one has an escape hatch: an inline
``# lint-ok: R<n> rationale`` comment on the flagged line (see
:mod:`repro_torch.analysis.lint`).

Rule catalog (the authoritative copy lives in ``src/repro_torch/README.md``):

* **R1 — recompile and rebuild hazards.**  ``torch.compile``,
  ``torch.jit.script``/``trace`` or a ``torch.cuda.CUDAGraph()`` created
  inside a ``for``/``while`` body (a fresh wrapper per iteration means a
  fresh compile cache, a fresh capture), ``torch.compile(<lambda>)(...)``
  invoked on the spot (the lambda is new every execution), a program table
  (``build_program_table`` / ``build_link_program_table``) built inside a
  loop (the zero-rebuild contract: one callable per bucket, made once), and
  ``torch.utils.cpp_extension.load``/``load_inline`` inside a loop.

* **R2 — stale aliases across an in-place write.**  The port's counterpart
  of use-after-donate: where the reference donates a buffer, the port
  writes its caches in place.  A name bound to ``X`` itself or to a view of
  it (``X[...]``, ``.view``, ``.reshape``, ``.narrow``, ``.select``,
  ``.expand``, ``.transpose``, ``.permute``, ``.unsqueeze``, ``.squeeze``,
  ``.detach``, ``.as_strided`` ...), then an in-place write into ``X`` in
  the same function (a method ending in ``_``, ``X[...] = ...``,
  ``out=X``), then a read of that name without rebinding: the name sees
  the new values.  ``.clone()`` is the sanctioned snapshot.  A subscript
  by a string constant (``cache["k"]``) is a container lookup, not a view,
  and assigning one rebinds the entry rather than writing the tensor.

* **R3 — hidden host syncs.**  The constructs: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")`` / ``.to(device="cpu")``;
  ``float()``/``int()``/``bool()`` of a non-constant;
  ``torch.cuda.synchronize()``, ``torch.equal``, ``torch.allclose``;
  ``.nonzero()`` / ``torch.nonzero`` / one-argument ``torch.where``;
  truthiness (``if``/``while``) on a call of ``.any()``/``.all()``; and a
  blocking host-to-device copy (``torch.from_numpy(...).to(...)`` or
  ``.cuda()``, ``torch.tensor``/``as_tensor(..., device=...)``).  They are
  flagged (b) anywhere inside a captured or compiled body (a ``with
  torch.cuda.graph(...)`` block, a function passed to
  ``torch.cuda.make_graphed_callables`` or ``torch.compile``, or decorated
  with it), and (c) once per iteration of a step loop: a loop whose body
  calls a step callable (a program-table entry, a name bound to
  ``torch.compile(...)`` or to a step maker, a graph's ``.replay()``, the
  model's step entries, or a function of this module that calls one),
  in the loop's body and in every function of this module that the body
  calls, directly or through others.  (d) Anywhere: indexing with a name
  bound in the same function to an index-valued reduction with no ``dim``
  (``torch.argmax/argmin(x)``, ``x.argmax()``): a 0-dim device index is
  read on the host (ROADMAP C9).

* **R4 — codec accounting completeness** and **R5 — asyncio race /
  hygiene** do not depend on the framework: the reference's rules, as they
  are (their messages name no JAX).
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator

Raw = tuple[int, int, str]     # (line, col, message)

_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.jit.trace_module"}
_GRAPHS = {"torch.cuda.CUDAGraph"}
_EXT_LOADERS = {"torch.utils.cpp_extension.load",
                "torch.utils.cpp_extension.load_inline"}
_PROGRAM_TABLE_BUILDERS = ("build_program_table", "build_link_program_table")
# the model's step entries, and the makers whose result is a step callable
_STEP_ENTRIES = {"decode_step", "prefill_chunk", "verify_chunk", "lm_loss",
                 "split_value_and_grad"}
_STEP_MAKERS = {"make_split_train_step", "make_train_step",
                "make_pipeline_step", "build_train_step"}
_VIEW_METHODS = {"view", "view_as", "reshape", "narrow", "select", "expand",
                 "expand_as", "transpose", "permute", "unsqueeze", "squeeze",
                 "detach", "as_strided", "flatten", "unflatten", "t",
                 "movedim", "swapaxes", "diagonal"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
_SYNC_CALLS = {"torch.cuda.synchronize", "torch.equal", "torch.allclose",
               "torch.nonzero"}
_SYNC_BUILTINS = {"float", "int", "bool"}
_ARG_REDUCTIONS = {"argmax", "argmin"}
_BLOCKING_IN_ASYNC = {"time.sleep", "os.system", "subprocess.run",
                      "subprocess.call", "subprocess.check_output",
                      "subprocess.check_call", "socket.create_connection"}
_TASK_SPAWNERS = {"create_task", "ensure_future"}
_MUTATORS = {"pop", "append", "remove", "clear", "update", "extend",
             "insert", "popitem", "setdefault", "add", "discard"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


# ---------------------------------------------------------------------------
# shared AST plumbing
# ---------------------------------------------------------------------------

def _parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, "_lint_parent", None)


def _ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = _parent(node)
    while cur is not None:
        yield cur
        cur = _parent(cur)


def _enclosing_function(node: ast.AST):
    for anc in _ancestors(node):
        if isinstance(anc, _FUNCS):
            return anc
    return None


def _in_loop_same_function(node: ast.AST) -> bool:
    """True when a loop encloses ``node`` WITHIN its own function scope
    (a loop outside the enclosing ``def`` does not re-execute it)."""
    for anc in _ancestors(node):
        if isinstance(anc, (*_FUNCS, ast.Lambda)):
            return False
        if isinstance(anc, _LOOPS):
            return True
    return False


def _own_nodes(fn: ast.AST) -> list[ast.AST]:
    """The nodes of ``fn``'s own scope (what nested defs, lambdas and
    classes hold excluded), listed by ``_prep``."""
    return fn._lint_own  # type: ignore[attr-defined]


def _nodes(tree: ast.AST) -> list[ast.AST]:
    """Every node of the tree in ``ast.walk``'s order, listed by ``_prep``."""
    return tree._lint_nodes  # type: ignore[attr-defined]


class _Imports(ast.NodeVisitor):
    """Alias map so ``F.pad`` resolves to ``torch.nn.functional.pad``,
    ``from torch.utils.cpp_extension import load`` resolves bare ``load``,
    etc."""

    def __init__(self):
        self.aliases: dict[str, str] = {}

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module is None:
            return
        for a in node.names:
            self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Best-effort dotted name of an expression, aliases resolved:
    ``F.pad`` -> ``torch.nn.functional.pad``, ``self._reset`` ->
    ``self._reset``.  None for anything not a Name/Attribute chain."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    head = aliases.get(cur.id, cur.id)
    return ".".join([head, *reversed(parts)])


def _tail(name: str | None) -> str | None:
    return None if name is None else name.rsplit(".", 1)[-1]


def _call_base(func: ast.AST, aliases: dict[str, str]) -> str | None:
    """The dispatchable base of a call target, subscripts peeled:
    ``step_fns[key](...)`` -> ``step_fns``;
    ``self._programs[b]["window"](...)`` -> ``self._programs``."""
    while isinstance(func, ast.Subscript):
        func = func.value
    return _dotted(func, aliases)


def _target_names(target: ast.AST, aliases: dict[str, str]) -> list[str]:
    """Dotted names bound by an assignment target (tuples flattened)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        out: list[str] = []
        for elt in target.elts:
            out.extend(_target_names(elt, aliases))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value, aliases)
    name = _dotted(target, aliases)
    return [name] if name is not None else []


def _prep(tree: ast.AST) -> dict[str, str]:
    """Parent links, the node list, each def's own nodes and the import
    alias map, made in one walk a tree (every rule of one ``lint_source``
    call walks the same tree)."""
    aliases = getattr(tree, "_lint_aliases", None)
    if aliases is not None:
        return aliases
    imp = _Imports()
    nodes = [tree]
    for node in nodes:            # breadth first, as ast.walk
        if isinstance(node, _FUNCS):
            node._lint_own = []
            inner = node
        elif isinstance(node, (ast.Lambda, ast.ClassDef)):
            inner = None
        else:
            inner = getattr(node, "_lint_scope", None)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            imp.visit(node)
        for child in ast.iter_child_nodes(node):
            child._lint_parent = node
            child._lint_scope = inner
            if inner is not None:
                inner._lint_own.append(child)
            nodes.append(child)
    tree._lint_nodes = nodes
    aliases = tree._lint_aliases = imp.aliases  # type: ignore[attr-defined]
    return aliases


def _assignments(tree: ast.AST):
    """(targets, value) of every Assign / AnnAssign with a value."""
    for node in _nodes(tree):
        if isinstance(node, ast.Assign):
            yield node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            yield [node.target], node.value


# ---------------------------------------------------------------------------
# R1 — recompile and rebuild hazards
# ---------------------------------------------------------------------------

def check_r1(tree: ast.AST, source: str, path: str) -> Iterable[Raw]:
    aliases = _prep(tree)
    for node in _nodes(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func, aliases)
        if callee is None:
            continue
        if callee in _COMPILERS:
            parent = _parent(node)
            if (callee == "torch.compile" and isinstance(parent, ast.Call)
                    and parent.func is node and node.args
                    and isinstance(node.args[0], ast.Lambda)):
                yield (node.lineno, node.col_offset,
                       "torch.compile(<lambda>)(...) can never hit the "
                       "compile cache (a fresh lambda object per execution "
                       "recompiles every call); name the function and "
                       "compile it once, or build a program table")
                continue
            what = f"{callee} wrapper"
        elif callee in _GRAPHS:
            what = "CUDA graph (torch.cuda.CUDAGraph)"
        elif callee in _EXT_LOADERS:
            what = f"extension build ({callee})"
        elif _tail(callee) in _PROGRAM_TABLE_BUILDERS:
            what = f"program table ({_tail(callee)})"
        else:
            continue
        if _in_loop_same_function(node):
            yield (node.lineno, node.col_offset,
                   f"{what} created inside a loop — a fresh one (and a fresh "
                   f"compile, capture or build) per iteration; hoist it out "
                   f"of the loop or pre-build a program table "
                   f"(codecs.build_program_table, one callable per bucket, "
                   f"made once) and dispatch host-side")


# ---------------------------------------------------------------------------
# R2 — stale aliases across an in-place write
# ---------------------------------------------------------------------------

def _is_str_key(sub: ast.Subscript) -> bool:
    return isinstance(sub.slice, ast.Constant) and isinstance(sub.slice.value,
                                                              str)


def _ref(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Identity of a storage location: a Name/Attribute chain, with string
    subscripts kept as container lookups (``cache['k']``)."""
    if isinstance(node, ast.Subscript) and _is_str_key(node):
        base = _ref(node.value, aliases)
        return None if base is None else f"{base}[{node.slice.value!r}]"
    return _dotted(node, aliases)


def _view_base(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """The storage ``node`` aliases: itself, or the base of a view chain
    (``X[...]``, ``X.view(...)``, ``X.detach()`` ...).  None for anything
    else, ``.clone()`` included."""
    while True:
        ref = _ref(node, aliases)
        if ref is not None:
            return ref
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in _VIEW_METHODS):
            node = node.func.value
        elif isinstance(node, ast.Attribute) and node.attr in ("T", "mT"):
            node = node.value
        else:
            return None


def _stmt_of(node: ast.AST) -> ast.AST:
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = _parent(cur)
    return cur if cur is not None else node


def _end(node: ast.AST) -> tuple[int, int]:
    stmt = _stmt_of(node)
    if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
                         ast.AsyncWith, ast.Try, *_FUNCS, ast.ClassDef)):
        # a compound statement's own part runs before its body
        return (node.end_lineno, node.end_col_offset)
    return (stmt.end_lineno, stmt.end_col_offset)


def _writes(node: ast.AST, aliases: dict[str, str]) -> list[str]:
    """Storage refs ``node`` writes in place."""
    out: list[str] = []
    if isinstance(node, ast.Call):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr.endswith("_")
                and not f.attr.startswith("_")):
            base = _view_base(f.value, aliases)
            if base is not None:
                out.append(base)
        for kw in node.keywords:
            if kw.arg == "out":
                base = _view_base(kw.value, aliases)
                if base is not None:
                    out.append(base)
    elif isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript) and not _is_str_key(t):
                base = _view_base(t.value, aliases)
                if base is not None:
                    out.append(base)
    return out


def check_r2(tree: ast.AST, source: str, path: str) -> Iterable[Raw]:
    aliases = _prep(tree)
    for fn in [n for n in _nodes(tree) if isinstance(n, _FUNCS)]:
        # events: (position, order, kind, name-or-ref, payload)
        events: list[tuple[tuple[int, int], int, str, str, object]] = []
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                single = [t for t in node.targets if isinstance(t, ast.Name)]
                base = _view_base(node.value, aliases)
                for t in single:
                    events.append((_end(node), 2, "bind", t.id,
                                   None if base == t.id else base))
            for ref in _writes(node, aliases):
                events.append((_end(node), 1, "write", ref, None))
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    events.append(((node.lineno, node.col_offset), 0, "load",
                                   node.id, node))
                elif not (isinstance(_parent(node), ast.Assign)
                          and node in _parent(node).targets):
                    # for-targets, with-as, augmented and tuple stores
                    events.append((_end(node), 2, "bind", node.id, None))
        events.sort(key=lambda e: (e[0], e[1]))
        bound: dict[str, tuple[str, int]] = {}   # alias -> (base, line)
        stale: dict[str, int] = {}               # alias -> write line
        for pos, _, kind, name, payload in events:
            if kind == "bind":
                stale.pop(name, None)
                if payload is None:
                    bound.pop(name, None)
                else:
                    bound[name] = (payload, pos[0])
            elif kind == "write":
                for alias, (base, _line) in bound.items():
                    if base == name and alias != name:
                        stale[alias] = pos[0]
            elif kind == "load" and name in stale:
                base, line = bound[name]
                yield (payload.lineno, payload.col_offset,
                       f"{name!r} aliases {base!r} (bound on line {line}) and "
                       f"is read after an in-place write into {base!r} on "
                       f"line {stale.pop(name)} — it sees the new values; "
                       f"take a .clone() before the write if the old ones "
                       f"are meant, or read {base!r} itself")


# ---------------------------------------------------------------------------
# R3 — hidden host syncs
# ---------------------------------------------------------------------------

def _is_device_kw(call: ast.Call) -> bool:
    return any(kw.arg == "device" for kw in call.keywords)


def _is_cpu(node: ast.AST, aliases: dict[str, str]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    return (isinstance(node, ast.Call)
            and _dotted(node.func, aliases) == "torch.device"
            and bool(node.args) and _is_cpu(node.args[0], aliases))


def _host_tensor(node: ast.AST, aliases: dict[str, str]) -> bool:
    """A tensor made from host memory: ``torch.from_numpy(...)``, or
    ``torch.tensor``/``as_tensor`` without a device."""
    if not isinstance(node, ast.Call):
        return False
    callee = _dotted(node.func, aliases)
    return callee == "torch.from_numpy" or (
        callee in ("torch.tensor", "torch.as_tensor") and not _is_device_kw(node))


def _sync_construct(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Describe ``node`` if it is a host-sync construct, else None."""
    if isinstance(node, (ast.If, ast.While)):
        test = node.test
        while isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        tests = test.values if isinstance(test, ast.BoolOp) else [test]
        for t in tests:
            if (isinstance(t, ast.Call) and isinstance(t.func, ast.Attribute)
                    and t.func.attr in ("any", "all")):
                return (f"truthiness of .{t.func.attr}() reads a device "
                        f"value on the host")
        return None
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_METHODS and not node.args and not node.keywords:
            return f".{f.attr}() forces a device->host transfer"
        if f.attr == "to":
            dests = [*node.args[:1], *(kw.value for kw in node.keywords
                                       if kw.arg == "device")]
            if any(_is_cpu(d, aliases) for d in dests):
                return ".to('cpu') forces a device->host transfer"
            if dests and _host_tensor(f.value, aliases):
                return ("a blocking host->device copy (.to of a host tensor) "
                        "waits for the stream")
        if f.attr == "cuda" and _host_tensor(f.value, aliases):
            return ("a blocking host->device copy (.cuda() of a host tensor) "
                    "waits for the stream")
    callee = _dotted(f, aliases)
    if callee in _SYNC_CALLS:
        return f"{callee}() blocks on device results"
    if callee == "torch.where" and len(node.args) == 1 and not node.keywords:
        return "torch.where(cond) with one argument is nonzero(): a host sync"
    if (callee in ("torch.tensor", "torch.as_tensor") and _is_device_kw(node)
            and not any(_is_cpu(kw.value, aliases) for kw in node.keywords
                        if kw.arg == "device")):
        return (f"{callee}(..., device=...) is a blocking host->device copy "
                f"that waits for the stream")
    if callee in _SYNC_BUILTINS and len(node.args) == 1 \
            and not isinstance(node.args[0], ast.Constant):
        return f"{callee}() on a device value forces a host sync"
    return None


def _is_compile_call(node: ast.AST, aliases: dict[str, str]) -> bool:
    return (isinstance(node, ast.Call)
            and _dotted(node.func, aliases) == "torch.compile")


def _captured_bodies(tree: ast.AST, aliases: dict[str, str]) -> list:
    """(label, nodes) of every captured or compiled body: a ``with
    torch.cuda.graph(...)`` block, a def passed by name to
    ``torch.cuda.make_graphed_callables`` or ``torch.compile`` or decorated
    with ``torch.compile`` (nested defs with it)."""
    by_name: dict[str, list[ast.AST]] = {}
    for node in _nodes(tree):
        if isinstance(node, _FUNCS):
            by_name.setdefault(node.name, []).append(node)
    fns: dict[ast.AST, str] = {}
    bodies = []
    for node in _nodes(tree):
        if isinstance(node, _FUNCS):
            for dec in node.decorator_list:
                if _dotted(dec, aliases) == "torch.compile" \
                        or _is_compile_call(dec, aliases):
                    fns[node] = f"torch.compile'd function {node.name!r}"
        elif isinstance(node, ast.Call):
            callee = _dotted(node.func, aliases)
            if callee in ("torch.compile",
                          "torch.cuda.make_graphed_callables") and node.args:
                arg = node.args[0]
                elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
                for e in elts:
                    name = _dotted(e, aliases)
                    for fn in by_name.get(name.rsplit(".", 1)[-1] if name else "", ()):
                        fns[fn] = (f"function {fn.name!r} passed to "
                                   f"{callee}")
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                e = item.context_expr
                if isinstance(e, ast.Call) and \
                        _dotted(e.func, aliases) == "torch.cuda.graph":
                    bodies.append((f"a torch.cuda.graph capture (line "
                                   f"{node.lineno})",
                                   [n for s in node.body for n in ast.walk(s)]))
    for fn, label in fns.items():
        bodies.append((label, list(ast.walk(fn))))
    return bodies


def _program_names(tree: ast.AST, aliases: dict[str, str]) -> set[str]:
    """Names bound to step callables: ``x = torch.compile(f)``, ``x =
    <...>.build_program_table(...)``, ``x = make_train_step(...)``, or a
    def decorated with torch.compile."""
    names: set[str] = set()
    for targets, value in _assignments(tree):
        if not isinstance(value, ast.Call):
            continue
        tail = _tail(_dotted(value.func, aliases))
        if not (_is_compile_call(value, aliases)
                or tail in _PROGRAM_TABLE_BUILDERS or tail in _STEP_MAKERS):
            continue
        for t in targets:
            names.update(_target_names(t, aliases))
    for node in _nodes(tree):
        if isinstance(node, _FUNCS) and any(
                _dotted(d, aliases) == "torch.compile"
                or _is_compile_call(d, aliases) for d in node.decorator_list):
            names.add(node.name)
    return names


class _Calls:
    """Module-local call resolution: a bare name to the defs of that name
    outside classes, ``self.name`` to the enclosing class's methods; a
    program table's dispatch to the defs nested in the maker that filled
    it (``build_program_table``'s ``make``, or a function whose result is
    stored into the table): the table's entries are those defs."""

    def __init__(self, tree: ast.AST, aliases: dict[str, str]):
        self.aliases = aliases
        self.plain: dict[str, list[ast.AST]] = {}
        self.methods: dict[tuple[ast.AST, str], list[ast.AST]] = {}
        for node in _nodes(tree):
            if isinstance(node, _FUNCS):
                owner = _parent(node)
                if isinstance(owner, ast.ClassDef):
                    self.methods.setdefault((owner, node.name), []).append(node)
                else:
                    self.plain.setdefault(node.name, []).append(node)
        self.entries: dict[str, list[ast.AST]] = {}
        for targets, value in _assignments(tree):
            if not isinstance(value, ast.Call):
                continue
            makers: list[ast.AST] = []
            if _tail(_dotted(value.func, aliases)) in _PROGRAM_TABLE_BUILDERS:
                make = [kw.value for kw in value.keywords if kw.arg == "make"]
                for m in [*value.args[2:3], *make]:
                    makers += self.resolve(m)
                names = [n for t in targets for n in _target_names(t, aliases)]
            else:
                makers = [m for m in self.resolve(value.func)
                          if any(isinstance(n, _FUNCS) for n in _own_nodes(m))]
                names = [_call_base(t, aliases) for t in targets
                         if isinstance(t, ast.Subscript)]
            nested = [n for m in makers for n in ast.walk(m)
                      if isinstance(n, _FUNCS) and n is not m]
            for name in names:
                if name is not None and nested:
                    self.entries.setdefault(name, []).extend(nested)

    def resolve(self, expr: ast.AST) -> list[ast.AST]:
        """The module-local defs a callee expression names."""
        if isinstance(expr, ast.Name):
            return self.plain.get(expr.id, [])
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            cls = next((a for a in _ancestors(expr)
                        if isinstance(a, ast.ClassDef)), None)
            return self.methods.get((cls, expr.attr), []) if cls else []
        return []

    def targets(self, call: ast.Call) -> list[ast.AST]:
        return [*self.resolve(call.func),
                *self.entries.get(_call_base(call.func, self.aliases), [])]


def _loops_of(node: ast.AST) -> list[ast.AST]:
    """The loops that run ``node`` once per iteration, innermost first: its
    enclosing loops within its own function (a ``for``'s iterable, made
    once, excluded)."""
    out, child = [], node
    for anc in _ancestors(node):
        if isinstance(anc, (*_FUNCS, ast.Lambda, ast.ClassDef)):
            break
        if isinstance(anc, _LOOPS) and not (
                isinstance(anc, (ast.For, ast.AsyncFor)) and child is anc.iter):
            out.append(anc)
        child = anc
    return out


def _step_loops(tree: ast.AST, aliases: dict[str, str]) -> dict:
    """{step loop: {module function it runs: the function the loop calls
    to reach it}}."""
    calls = _Calls(tree, aliases)
    programs = _program_names(tree, aliases) | set(calls.entries)

    def direct_step(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "replay" and not node.args:
            return True
        if _call_base(f, aliases) in programs:
            return True
        return _tail(_dotted(f, aliases)) in _STEP_ENTRIES

    funcs = [n for n in _nodes(tree) if isinstance(n, _FUNCS)]
    callees = {fn: {t for n in _own_nodes(fn) if isinstance(n, ast.Call)
                    for t in calls.targets(n)} for fn in funcs}
    stepping = {fn for fn in funcs if any(map(direct_step, _own_nodes(fn)))}
    grew = True
    while grew:                       # functions that reach a step callable
        grew = False
        for fn in funcs:
            if fn not in stepping and callees[fn] & stepping:
                stepping.add(fn)
                grew = True

    # a step loop encloses, in its own function, a call of a step callable
    targets = {n: calls.targets(n) for n in _nodes(tree)
               if isinstance(n, ast.Call)}
    step_loops: dict[ast.AST, dict[ast.AST, str]] = {}
    for call, tgts in targets.items():
        if direct_step(call) or any(t in stepping for t in tgts):
            for lp in _loops_of(call):
                step_loops.setdefault(lp, {})
    for call, tgts in targets.items():
        for lp in _loops_of(call):
            if lp in step_loops:
                todo = [(t, None) for t in tgts]
                reached = step_loops[lp]
                while todo:            # what the loop runs, through whom
                    fn, via = todo.pop()
                    if fn not in reached:
                        reached[fn] = via or fn.name
                        todo.extend((t, reached[fn]) for t in callees[fn])
    return step_loops


def _arg_reduction(value: ast.AST, aliases: dict[str, str]) -> bool:
    """``torch.argmax(x)`` / ``x.argmin()`` with no dim: a 0-dim index."""
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    callee = _dotted(f, aliases)
    if callee in ("torch.argmax", "torch.argmin"):
        return len(value.args) <= 1 and not any(
            kw.arg == "dim" for kw in value.keywords)
    return (isinstance(f, ast.Attribute) and f.attr in _ARG_REDUCTIONS
            and not value.args and not any(kw.arg == "dim"
                                           for kw in value.keywords))


def check_r3(tree: ast.AST, source: str, path: str) -> Iterable[Raw]:
    aliases = _prep(tree)
    seen: set[tuple[int, int]] = set()

    def once(node, message):
        key = (node.lineno, node.col_offset)
        if key in seen:
            return None
        seen.add(key)
        return (node.lineno, node.col_offset, message)

    # (b) inside captured or compiled bodies
    for label, nodes in _captured_bodies(tree, aliases):
        for node in nodes:
            desc = _sync_construct(node, aliases)
            if desc is not None:
                hit = once(node, f"{desc} inside {label} (a capture fails on "
                                 f"it; a compiled body breaks its graph there)")
                if hit:
                    yield hit

    # (c) once per iteration of a step loop: its body, then what it calls
    loops = _step_loops(tree, aliases)
    for node in _nodes(tree):
        inner = [lp for lp in _loops_of(node) if lp in loops] \
            if isinstance(node, (ast.Call, ast.If, ast.While)) else []
        desc = _sync_construct(node, aliases) if inner else None
        if desc is not None:
            hit = once(node, f"{desc} every iteration of the step loop on "
                             f"line {inner[0].lineno} — the sync serializes "
                             f"dispatch with compute (and a CUDA graph "
                             f"cannot hold it); keep the value on the "
                             f"device and convert after the loop (or gate "
                             f"it on the logging cadence)")
            if hit:
                yield hit
    for loop in sorted(loops, key=lambda lp: lp.lineno):
        for fn, via in loops[loop].items():
            for node in _own_nodes(fn):
                desc = _sync_construct(node, aliases)
                if desc is not None:
                    hit = once(node, f"{desc} in {fn.name!r}, which the step "
                                     f"loop on line {loop.lineno} runs every "
                                     f"iteration (through {via!r}) — the sync "
                                     f"serializes dispatch with compute (and "
                                     f"a CUDA graph cannot hold it)")
                    if hit:
                        yield hit

    # (d) indexing with a 0-dim device index, in any function
    for fn in [n for n in _nodes(tree) if isinstance(n, _FUNCS)]:
        nodes = _own_nodes(fn)
        zero_dim: dict[str, int] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) and _arg_reduction(node.value, aliases):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        zero_dim[t.id] = node.lineno
        if not zero_dim:
            continue
        for node in nodes:
            if not isinstance(node, ast.Subscript):
                continue
            idx = node.slice
            parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            for p in parts:
                if isinstance(p, ast.Name) and p.id in zero_dim \
                        and zero_dim[p.id] < node.lineno:
                    hit = once(node, f"indexing with {p.id!r}, a 0-dim index "
                                     f"from an arg-reduction with no dim (line "
                                     f"{zero_dim[p.id]}), reads it on the host "
                                     f"(aten._local_scalar_dense); keep a (1,) "
                                     f"index (.reshape(1)) and index_select")
                    if hit:
                        yield hit


# ---------------------------------------------------------------------------
# R4 — codec accounting completeness (the reference's rule, as it is)
# ---------------------------------------------------------------------------

_R4_REQUIRED = {"transform": ("payload_shape", "wire_bytes", "flops"),
                "wire": ("wire_bytes", "flops", "apply")}


def check_r4(tree: ast.AST, source: str, path: str) -> Iterable[Raw]:
    aliases = _prep(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            callee = _dotted(dec.func, aliases)
            if callee is None or callee.rsplit(".", 1)[-1] != "register":
                continue
            kind = "transform"
            for kw in dec.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                    kind = str(kw.value.value)
            required = _R4_REQUIRED.get(kind, _R4_REQUIRED["transform"])
            defined = {n.name for n in node.body if isinstance(n, _FUNCS)}
            missing = [m for m in required if m not in defined]
            if missing:
                yield (node.lineno, node.col_offset,
                       f"registered {kind} codec {node.name!r} does not "
                       f"implement {', '.join(missing)} in its own body — "
                       f"every wire stage must carry the exact byte/FLOP "
                       f"accounting surface (the wire-byte stats and the "
                       f"comm benches depend on it)")


# ---------------------------------------------------------------------------
# R5 — asyncio race / hygiene (the reference's rule, as it is)
# ---------------------------------------------------------------------------

def _handles_cancelled(handler: ast.ExceptHandler,
                       aliases: dict[str, str]) -> bool:
    t = handler.type
    types = t.elts if isinstance(t, ast.Tuple) else ([t] if t else [])
    for typ in types:
        name = _dotted(typ, aliases)
        if name is not None and name.rsplit(".", 1)[-1] == "CancelledError":
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    # raising ANYTHING keeps the cancellation path loud enough
    return any(isinstance(node, ast.Raise) for node in ast.walk(handler))


def _container_key(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """The shared-container identity an async loop iterates: a bare
    name / attribute, or the same with .items()/.keys()/.values()."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("items", "keys", "values") \
            and not node.args:
        node = node.func.value
    return _dotted(node, aliases)


def check_r5(tree: ast.AST, source: str, path: str) -> Iterable[Raw]:
    aliases = _prep(tree)
    async_fns = [n for n in ast.walk(tree)
                 if isinstance(n, ast.AsyncFunctionDef)]

    for fn in async_fns:
        for node in ast.walk(fn):
            if _enclosing_function(node) is not fn:
                continue
            # R5a: blocking call on the event loop thread
            if isinstance(node, ast.Call):
                callee = _dotted(node.func, aliases)
                if callee in _BLOCKING_IN_ASYNC:
                    yield (node.lineno, node.col_offset,
                           f"blocking {callee}() inside async def "
                           f"{fn.name!r} stalls the single-threaded event "
                           f"loop (every tenant pays); use the asyncio "
                           f"equivalent or run_in_executor")
            # R5c: swallowed cancellation
            if isinstance(node, ast.ExceptHandler) \
                    and _handles_cancelled(node, aliases) \
                    and not _reraises(node):
                yield (node.lineno, node.col_offset,
                       f"except CancelledError without re-raise in async "
                       f"def {fn.name!r} — swallowing cancellation breaks "
                       f"task.cancel()-based shutdown (the PR 7 orphan-"
                       f"task cleanup relies on it propagating)")
            # R5d: mutate-while-iterating across an await
            if isinstance(node, (ast.For, ast.AsyncFor)):
                key = _container_key(node.iter, aliases)
                if key is None:
                    continue
                body = [n for stmt in node.body for n in ast.walk(stmt)]
                if not any(isinstance(n, ast.Await) for n in body):
                    continue
                mutated = False
                for n in body:
                    if isinstance(n, (ast.Delete, ast.Assign)):
                        for t in n.targets:
                            if isinstance(t, ast.Subscript) \
                                    and _dotted(t.value, aliases) == key:
                                mutated = True
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and n.func.attr in _MUTATORS \
                            and _dotted(n.func.value, aliases) == key:
                        mutated = True
                if mutated:
                    yield (node.lineno, node.col_offset,
                           f"iterating {key!r} with an await in the body "
                           f"while also mutating it — the await yields to "
                           f"handlers that may touch the same container; "
                           f"iterate a snapshot (list({key})) instead")

    # R5b: dropped task reference (any scope, not just async defs —
    # a sync helper can spawn tasks too)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Expr) or not isinstance(node.value,
                                                            ast.Call):
            continue
        call = node.value
        callee = _dotted(call.func, aliases)
        tail = callee.rsplit(".", 1)[-1] if callee else (
            call.func.attr if isinstance(call.func, ast.Attribute) else None)
        if tail in _TASK_SPAWNERS:
            yield (node.lineno, node.col_offset,
                   "task spawned and its reference dropped — the event "
                   "loop holds only a weak ref, so the task can be "
                   "garbage-collected mid-flight and its exceptions are "
                   "never observed; retain it (self._tasks.add / await)")


CHECKERS = {"R1": check_r1, "R2": check_r2, "R3": check_r3,
            "R4": check_r4, "R5": check_r5}
