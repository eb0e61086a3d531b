"""Idempotency-classification drift gate (stdlib ``ast`` only).

A copy of the reference's ``repro/analysis/idemlint.py`` with its rules
unchanged. Run as ``python -m repro_torch.analysis.idemlint [paths...]``
(default: ``src/repro_torch``). Exits non-zero on any violation; there
is no suppression mechanism — a new violation means the code or the spec
should change.

Retrying transports deliver RPCs at least once; exactly-once *effect*
depends on every payloadtype being correctly classified in
``repro_torch.core.idempotency.SPEC`` (KEYED / NATURAL / READ). This
lint proves the spec matches the dispatch tables:

* **IDM001 unclassified** — a payloadtype registered in a handler table
  (``{"ptype": self._h_x}`` dict literal, server or extension) has no
  entry in the SPEC literal. An unclassified mutating RPC silently gets
  READ semantics: the client stamps no msgid, a retry duplicates state.
* **IDM002 mutating-read** — a handler whose call cone (transitively,
  through ``self.<m>`` / ``self.server.<m>`` methods) reaches a
  database mutator is classified READ. Same failure shape as IDM001,
  but for a mis-filed entry rather than a missing one.
* **IDM003 stale-spec** — a SPEC entry names a payloadtype no handler
  table registers: dead weight that misdocuments the RPC surface.
* **IDM004 keyed-read-only** — a handler that never reaches a database
  mutator is classified KEYED or NATURAL: every such call pays a dedup
  write (KEYED) for an effect that cannot duplicate, hiding the real
  hot-path cost the benchmark gate bounds.

Heartbeat writes (``touch_executor``) and the dedup table's own
bookkeeping (``dedup_put``) are not mutators here: they are read-path
side effects whose duplication is harmless by construction.
"""

from __future__ import annotations

import ast
import os
import sys

DEFAULT_PATHS = ("src/repro_torch",)

# Database writes whose duplication an RPC retry must not produce.
# Deliberately broader than replint.DB_MUTATORS (which only tracks
# replica-observable process writes): any persistent state counts here.
MUTATORS = frozenset(
    {
        "add_colony",
        "add_executor",
        "set_executor_state",
        "remove_executor",
        "add_function",
        "add_process",
        "update_process",
        "requeue",
        "delete_process",
        "cron_put",
        "cron_del",
        "generator_put",
        "generator_del",
        "user_put",
        "user_del",
        "kv_put",
        "kv_del",
        "kv_append",
        "kv_take_all",
        "cfs_add_file",
        "cfs_remove_file",
        "cfs_create_snapshot",
        "cfs_remove_snapshot",
        "_write_process",
        "executemany",
    }
)

# Read-path side effects exempt from MUTATORS (duplication harmless).
EXEMPT = frozenset({"touch_executor", "dedup_put", "dedup_get"})


class Violation:
    __slots__ = ("path", "line", "rule", "msg")

    def __init__(self, path: str, line: int, rule: str, msg: str) -> None:
        self.path = path
        self.line = line
        self.rule = rule
        self.msg = msg

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _method_calls(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> tuple[bool, set[str]]:
    """(mutates directly?, bare self./self.server. callee names)."""
    mutates = False
    calls: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        parts = _dotted(node.func).split(".")
        leaf = parts[-1]
        if (
            len(parts) >= 3
            and parts[0] == "self"
            and parts[-2] in ("db", "_db", "_conn")
            and leaf in MUTATORS
            and leaf not in EXEMPT
        ):
            mutates = True
        elif parts[0] == "self" and leaf in MUTATORS and leaf not in EXEMPT:
            # direct private helpers like self._write_process(...)
            mutates = True
        elif parts[0] == "self" and (
            len(parts) == 2 or (len(parts) == 3 and parts[1] == "server")
        ):
            calls.add(leaf)
    return mutates, calls


def analyze(sources: list[tuple[str, str]]) -> list[Violation]:
    out: list[Violation] = []
    registered: dict[str, tuple[str, str, int]] = {}  # ptype -> (path, handler, line)
    spec: dict[str, str] = {}
    spec_site: tuple[str, int] = ("", 0)
    methods: dict[str, tuple[bool, set[str]]] = {}
    handler_site: dict[str, tuple[str, int]] = {}

    for path, src in sources:
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            out.append(Violation(path, e.lineno or 0, "IDM000", f"syntax error: {e.msg}"))
            continue
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                mutates, calls = _method_calls(fn)
                prev = methods.get(fn.name)
                if prev is not None:  # same-named methods merge conservatively
                    mutates = mutates or prev[0]
                    calls = calls | prev[1]
                methods[fn.name] = (mutates, calls)
                handler_site.setdefault(fn.name, (path, fn.lineno))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                if isinstance(v, ast.Attribute) and v.attr.startswith("_h_"):
                    registered[k.value] = (path, v.attr, k.lineno or 0)
                elif (
                    path.endswith("idempotency.py")
                    and isinstance(v, ast.Name)
                    and v.id in ("KEYED", "NATURAL", "READ")
                ):
                    spec[k.value] = v.id.lower()
                    spec_site = (path, k.lineno or 0)

    # Propagate mutation through the call graph to a fixpoint.
    changed = True
    while changed:
        changed = False
        for name, (mutates, calls) in methods.items():
            if mutates:
                continue
            if any(methods.get(c, (False, set()))[0] for c in calls):
                methods[name] = (True, calls)
                changed = True

    if not spec:
        out.append(
            Violation(
                "src/repro_torch/core/idempotency.py",
                0,
                "IDM000",
                "no SPEC literal found (idempotency.py missing or rewritten"
                " without the payloadtype classification dict)",
            )
        )
        return out

    for ptype, (path, handler, line) in sorted(registered.items()):
        cls = spec.get(ptype)
        mutates = methods.get(handler, (False, set()))[0]
        if cls is None:
            out.append(
                Violation(
                    path,
                    line,
                    "IDM001",
                    f"payloadtype {ptype!r} ({handler}) is not classified in"
                    " idempotency.SPEC — a retried call would silently get"
                    " READ semantics",
                )
            )
            continue
        if mutates and cls == "read":
            out.append(
                Violation(
                    path,
                    line,
                    "IDM002",
                    f"payloadtype {ptype!r} ({handler}) reaches a database"
                    " mutator but is classified READ — retries can duplicate"
                    " its effect",
                )
            )
        elif not mutates and cls != "read":
            out.append(
                Violation(
                    path,
                    line,
                    "IDM004",
                    f"payloadtype {ptype!r} ({handler}) never reaches a"
                    f" database mutator but is classified {cls.upper()}",
                )
            )
    for ptype in sorted(set(spec) - set(registered)):
        out.append(
            Violation(
                spec_site[0],
                spec_site[1],
                "IDM003",
                f"idempotency.SPEC classifies {ptype!r} but no handler table"
                " registers it (stale entry)",
            )
        )
    return out


def lint_source(src: str, path: str) -> list[Violation]:
    """Single-source convenience (rule fixtures in tests)."""
    return analyze([(path, src)])


def _py_files(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in names if n.endswith(".py"))
    return sorted(files)


def run(paths: list[str] | None = None) -> tuple[int, list[Violation]]:
    if not paths:
        paths = [p for p in DEFAULT_PATHS if os.path.exists(p)]
    files = _py_files(paths)
    sources = []
    for f in files:
        with open(f, "r", encoding="utf-8") as fh:
            sources.append((f, fh.read()))
    return len(files), analyze(sources)


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    nfiles, vs = run(args)
    for v in vs:
        print(v)
    if vs:
        print(f"repro_torch.analysis.idemlint: {len(vs)} violation(s) in {nfiles} files")
        return 1
    print(f"repro_torch.analysis.idemlint: OK ({nfiles} files clean)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
