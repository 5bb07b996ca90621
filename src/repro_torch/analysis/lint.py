"""Repo-custom lint — runtime idioms that keep the port's resident path honest.

Pure-AST (no imports of the linted modules), four rules, the JAX package's
``repro.analysis.lint`` re-aimed at the port's idioms:

* ``perf-counter`` — ``time.perf_counter`` belongs to ``obs/timing.py``
  alone; everything else routes through
  :func:`repro_torch.obs.timing.wall_clock` / ``Stopwatch`` / ``timed_into``
  so timing accounting stays uniform (and traceable) across the runtime.
* ``host-sync`` — the run methods of the resident executables (every method
  but ``__init__`` / ``_setup`` of a class named ``*Executable``, which
  upload their plans at construction by design) must stay device-pure: no
  ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize()`` / ``.synchronize()`` and no call of the
  port's fetch helper ``_to_numpy`` inside — one stray sync serializes
  every round of a resident iteration.
* ``plan-key-fields`` — multiply-family plan-cache keys (tuples tagged
  ``"spgemm"`` / ``"spamm"`` / ``"spamm-delta"`` that fingerprint a mesh)
  must carry both operand dtypes and the precision policy key; a key
  missing them silently reuses a plan built for other numerics.  The tag
  may be a constant, or a parameter of the enclosing function that some
  call in the module passes one of the three tags (a key helper such as
  ``_plan_key(kind, ...)``).
* ``device-transfer`` — no device->host fetch (``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``.item()``, ``_to_numpy``) and no block-data upload
  (``torch.as_tensor`` / ``torch.tensor`` with a ``device=``,
  ``torch.from_numpy(...).to(...)``, or ``x.to(<mesh>.device)``) inside
  resident collective bodies (``dist_*`` functions): iterates never cross
  host<->device mid-run, and one stray transfer reintroduces per-call
  motion that planning can't see.
  Construction-time entry points are baseline-waived.

Findings are waived by ``<relpath>::<rule>`` lines in a checked-in baseline
file (``lint_baseline.txt`` next to this module), each with its reason.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

__all__ = ["Finding", "lint_file", "lint_paths", "load_baseline",
           "fix_perf_counter_source", "fix_paths",
           "DEFAULT_BASELINE", "default_root"]

# files allowed to touch time.perf_counter directly
_CLOCK_HOME = ("obs/timing.py",)
# plan-key kinds that must fingerprint numerics (dtype + precision)
_PLAN_KEY_KINDS = {"spgemm", "spamm", "spamm-delta"}
# host-sync: methods of *Executable classes, but the construction-time ones
_EXECUTABLE_SUFFIX = "Executable"
_CONSTRUCTION = ("__init__", "_setup")
# the port's device -> host fetch helper (repro_torch.core.matrix)
_FETCH_HELPER = "_to_numpy"
_FETCH_METHODS = ("cpu", "numpy", "tolist", "item")
_UPLOAD_FUNCS = ("as_tensor", "tensor")

DEFAULT_BASELINE = Path(__file__).with_name("lint_baseline.txt")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str  # posix path relative to the lint root
    line: int
    rule: str
    message: str

    @property
    def key(self) -> str:
        """Baseline waiver key — stable across line-number churn."""
        return f"{self.path}::{self.rule}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _is_perf_counter(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "perf_counter") or (
        isinstance(node, ast.Name) and node.id == "perf_counter"
    )


def _check_perf_counter(tree, relpath, out):
    if relpath.endswith(_CLOCK_HOME):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "perf_counter":
                    out.append(Finding(
                        relpath, node.lineno, "perf-counter",
                        "import time.perf_counter outside obs/timing.py — "
                        "use repro_torch.obs.timing.wall_clock/Stopwatch",
                    ))
        elif isinstance(node, ast.Attribute) and node.attr == "perf_counter":
            out.append(Finding(
                relpath, node.lineno, "perf-counter",
                "time.perf_counter outside obs/timing.py — use "
                "repro_torch.obs.timing.wall_clock/Stopwatch",
            ))


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for a chain of names and attributes, else ``""``."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _fetch(call: ast.Call) -> str | None:
    """The device -> host fetch a call makes, or None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _FETCH_METHODS and not call.args:
        return f".{f.attr}()"
    if isinstance(f, ast.Name) and f.id == _FETCH_HELPER:
        return f"{_FETCH_HELPER}()"
    return None


def _host_sync(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "synchronize":
        return "torch.cuda.synchronize()" if _dotted(f) == "torch.cuda.synchronize" \
            else ".synchronize()"
    return _fetch(call)


def _executable_methods(tree):
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef) and cls.name.endswith(_EXECUTABLE_SUFFIX)):
            continue
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name not in _CONSTRUCTION:
                yield cls.name, fn


def _check_host_sync(tree, relpath, out):
    for cls, fn in _executable_methods(tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            sync = _host_sync(node)
            if sync:
                out.append(Finding(
                    relpath, node.lineno, "host-sync",
                    f"{sync} inside {cls}.{fn.name}() — executable runs must "
                    f"stay device-pure (host syncs serialize the rounds)",
                ))


def _tuple_has(node: ast.Tuple, pred) -> int:
    return sum(1 for elt in node.elts for sub in ast.walk(elt) if pred(sub))


def _key_kind_params(tree) -> dict[ast.AST, set[str]]:
    """Per function: its parameters that some call in the module passes a
    plan-key tag as a constant (positionally or by keyword)."""
    funcs = {fn.name: fn for fn in ast.walk(tree)
             if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))}
    params: dict[ast.AST, set[str]] = {}
    for call in ast.walk(tree):
        if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                and call.func.id in funcs):
            continue
        fn = funcs[call.func.id]
        names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        passed = list(zip(names, call.args)) + [(k.arg, k.value) for k in call.keywords]
        for name, value in passed:
            if isinstance(value, ast.Constant) and value.value in _PLAN_KEY_KINDS:
                params.setdefault(fn, set()).add(name)
    return params


def _plan_key_tuples(tree):
    """``(tuple, tag)`` for every tuple headed by a plan-key tag: a constant,
    or a parameter of the enclosing function that callers pass a tag."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Tuple) and node.elts:
            head = node.elts[0]
            if isinstance(head, ast.Constant) and head.value in _PLAN_KEY_KINDS:
                yield node, repr(head.value)
    for fn, names in _key_kind_params(tree).items():
        for node in ast.walk(fn):
            if (isinstance(node, ast.Tuple) and node.elts
                    and isinstance(node.elts[0], ast.Name) and node.elts[0].id in names):
                yield node, node.elts[0].id


def _check_plan_keys(tree, relpath, out):
    for node, tag in _plan_key_tuples(tree):
        # only distributed plan keys (they fingerprint the mesh); the
        # single-host symbolic cache keys share the tag but carry no mesh
        fingerprints_mesh = _tuple_has(node, lambda s: isinstance(s, ast.Call)
                                       and isinstance(s.func, ast.Name)
                                       and s.func.id == "mesh_key")
        if not fingerprints_mesh:
            continue
        dtypes = _tuple_has(
            node,
            lambda s: isinstance(s, ast.Call)
            and isinstance(s.func, ast.Name) and s.func.id == "str"
            and len(s.args) == 1 and isinstance(s.args[0], ast.Attribute)
            and s.args[0].attr == "dtype",
        )
        precision = _tuple_has(node, lambda s: isinstance(s, ast.Call)
                               and isinstance(s.func, ast.Attribute)
                               and s.func.attr == "key")
        if dtypes < 2 or precision < 1:
            out.append(Finding(
                relpath, node.lineno, "plan-key-fields",
                f"{tag} plan key carries {dtypes} operand dtype "
                f"field(s) and {precision} precision key(s) — both operand "
                f"dtypes and precision.key() are mandatory (a stale key "
                f"reuses a plan built for other numerics)",
            ))


def _upload(call: ast.Call) -> str | None:
    """The block-data upload a call makes, or None."""
    f = call.func
    if _dotted(f) in {f"torch.{n}" for n in _UPLOAD_FUNCS} \
            and any(k.arg == "device" for k in call.keywords):
        return f"{_dotted(f)}(device=...)"
    if not (isinstance(f, ast.Attribute) and f.attr in ("to", "cuda")):
        return None
    if isinstance(f.value, ast.Call) and _dotted(f.value.func) == "torch.from_numpy":
        return f"torch.from_numpy(...).{f.attr}()"
    # an explicit move of a tensor to a device: .to(<x>.device) / .to(device=...)
    target = [k.value for k in call.keywords if k.arg == "device"] + call.args[:1]
    if f.attr == "to" and target and isinstance(target[0], ast.Attribute) \
            and target[0].attr == "device":
        return f".to({_dotted(target[0]) or '...'})"
    return None


def _check_device_transfer(tree, relpath, out):
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not fn.name.startswith("dist_"):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            what = _fetch(node) or _upload(node)
            if what:
                out.append(Finding(
                    relpath, node.lineno, "device-transfer",
                    f"{what} inside resident collective {fn.name}() "
                    f"— iterates must stay on device; scatter/gather are the "
                    f"only sanctioned boundary crossings",
                ))


_RULES = (
    _check_perf_counter,
    _check_host_sync,
    _check_plan_keys,
    _check_device_transfer,
)


# ---------------------------------------------------------------------------
# --fix: mechanical rewrites for the perf-counter rule
# ---------------------------------------------------------------------------

_TIMING_IMPORT = "repro_torch.obs.timing"


def _line_starts(src: str) -> list[int]:
    starts, pos = [0], 0
    for line in src.splitlines(keepends=True):
        pos += len(line)
        starts.append(pos)
    return starts


def fix_perf_counter_source(src: str) -> tuple[str, int]:
    """Rewrite ``time.perf_counter`` idioms to their ``repro_torch.obs.timing``
    equivalents; returns ``(new_source, edits)``.

    Three patterns, matched on the AST (so strings/comments are safe) and
    rewritten by exact source position:

    * ``t0 = time.perf_counter()``      -> ``t0 = Stopwatch()``
    * ``time.perf_counter() - t0``      -> ``t0.elapsed()``  (paired names)
    * any other bare call               -> ``wall_clock()``

    plus removal of ``perf_counter`` from ``from time import ...`` lines and
    insertion of the needed ``from repro_torch.obs.timing import ...``.
    Anything fancier (the callable passed as a clock default, calls with
    arguments) is left alone and stays a lint finding.  Running the fixer on
    its own output is a no-op: the rewritten source contains no matchable
    pattern.
    """
    tree = ast.parse(src)
    edits: list[tuple[int, int, int, int, str]] = []
    watches: set[str] = set()
    handled: set[int] = set()
    need: set[str] = set()

    def span(node):
        return (node.lineno, node.col_offset,
                node.end_lineno, node.end_col_offset)

    def bare_call(node):
        return (isinstance(node, ast.Call) and _is_perf_counter(node.func)
                and not node.args and not node.keywords)

    # names read back as `time.perf_counter() - NAME` are stopwatch starts;
    # an assignment never subtracted from is just a timestamp (wall_clock)
    for node in ast.walk(tree):
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
                and bare_call(node.left)
                and isinstance(node.right, ast.Name)):
            watches.add(node.right.id)
    # stopwatch starts: NAME = time.perf_counter()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in watches
                and bare_call(node.value)):
            handled.add(id(node.value))
            edits.append(span(node.value) + ("Stopwatch()",))
            need.add("Stopwatch")
    # stopwatch reads: time.perf_counter() - NAME
    for node in ast.walk(tree):
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
                and bare_call(node.left)
                and isinstance(node.right, ast.Name)
                and node.right.id in watches):
            handled.add(id(node.left))
            edits.append(span(node) + (f"{node.right.id}.elapsed()",))
    # everything else that is a plain zero-arg call
    for node in ast.walk(tree):
        if bare_call(node) and id(node) not in handled:
            edits.append(span(node) + ("wall_clock()",))
            need.add("wall_clock")
    # import surgery: drop perf_counter from `from time import ...`
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            keep = [a for a in node.names if a.name != "perf_counter"]
            if len(keep) == len(node.names):
                continue
            repl = ("from time import " + ", ".join(
                a.name + (f" as {a.asname}" if a.asname else "")
                for a in keep)) if keep else ""
            edits.append(span(node) + (repl,))

    if not edits:
        return src, 0

    # the timing import the rewrites rely on (skip names already imported)
    for node in tree.body:
        if (isinstance(node, ast.ImportFrom)
                and node.module and node.module.endswith("obs.timing")):
            need -= {a.asname or a.name for a in node.names}
    n_edits = len(edits)
    starts = _line_starts(src)
    out = src
    dropped_lines: list[int] = []
    for l0, c0, l1, c1, repl in sorted(edits, reverse=True):
        lo, hi = starts[l0 - 1] + c0, starts[l1 - 1] + c1
        if repl == "" and c0 == 0 and out[hi:hi + 1] == "\n":
            hi += 1  # deleting a whole import line takes its newline along
            dropped_lines.append(l0)
        out = out[:lo] + repl + out[hi:]
    if need:
        line = f"from {_TIMING_IMPORT} import " + ", ".join(sorted(need))
        # insert after the last top-level import (they all precede code in
        # this tree), else after the module docstring / at the top
        anchor = 0
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                anchor = max(anchor, node.end_lineno)
            elif (anchor == 0 and isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                anchor = node.end_lineno
        anchor -= sum(1 for ln in dropped_lines if ln <= anchor)
        lines = out.splitlines(keepends=True)
        lines.insert(anchor, line + "\n")
        out = "".join(lines)
        n_edits += 1
    return out, n_edits


def _py_files(root: Path) -> tuple[list[Path], Path]:
    """The ``.py`` files under a lint root and the base their paths are relative to."""
    if root.is_file():
        return [root], root.parent
    return sorted(root.rglob("*.py")), root


def fix_paths(roots: list[Path] | None = None,
              *, baseline: set[str] | None = None) -> list[tuple[str, int]]:
    """Apply :func:`fix_perf_counter_source` to every file with an unwaived
    ``perf-counter`` finding; returns ``[(relpath, edits), ...]``."""
    roots = [default_root()] if roots is None else [Path(r) for r in roots]
    baseline = load_baseline() if baseline is None else baseline
    done: list[tuple[str, int]] = []
    for root in roots:
        files, base = _py_files(root)
        for f in files:
            hits = [x for x in lint_file(f, base)
                    if x.rule == "perf-counter" and x.key not in baseline]
            if not hits:
                continue
            new, n = fix_perf_counter_source(f.read_text())
            if n:
                f.write_text(new)
                done.append((hits[0].path, n))
    return done


def default_root() -> Path:
    """The runtime tree the lint governs: ``src/repro_torch``."""
    return Path(__file__).resolve().parents[1]


def lint_file(path: Path, root: Path) -> list[Finding]:
    relpath = path.resolve().relative_to(root.resolve()).as_posix()
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as exc:  # pragma: no cover - defensive
        return [Finding(relpath, exc.lineno or 0, "syntax", str(exc))]
    out: list[Finding] = []
    for rule in _RULES:
        rule(tree, relpath, out)
    return out


def load_baseline(path: Path | None = None) -> set[str]:
    path = DEFAULT_BASELINE if path is None else Path(path)
    if not path.exists():
        return set()
    keys = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            keys.add(line)
    return keys


def lint_paths(
    roots: list[Path] | None = None,
    *,
    baseline: set[str] | None = None,
) -> tuple[list[Finding], list[Finding]]:
    """Lint every ``.py`` under ``roots`` (default: ``src/repro_torch``).

    Returns ``(findings, waived)`` — findings whose key appears in the
    baseline move to the waived list.
    """
    roots = [default_root()] if roots is None else [Path(r) for r in roots]
    baseline = load_baseline() if baseline is None else baseline
    findings: list[Finding] = []
    waived: list[Finding] = []
    for root in roots:
        files, base = _py_files(root)
        for f in files:
            for finding in lint_file(f, base):
                (waived if finding.key in baseline else findings).append(finding)
    return findings, waived
