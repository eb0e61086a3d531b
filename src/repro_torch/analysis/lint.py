"""Repo-specific static concurrency/hygiene lint (stdlib ``ast`` only).

A copy of the reference's ``repro/analysis/lint.py`` with its rules
unchanged. Run as ``python -m repro_torch.analysis.lint [paths...]``
(default: ``src/repro_torch``). Exits non-zero on any violation; there
is no suppression mechanism — rules are written so the repo passes with
zero exceptions, and a new violation means the code (not the lint)
should change.

Rules:

* **LNT001 kv-list-scan** — no ``kv_list`` call outside ``_migrate*``
  functions. Every hot path must use an indexed first-class table
  (processes, cfs_files, crons, generators, ...); ``kv_list`` is a full
  table scan and exists only so sqlite migrations can drain legacy rows.
* **LNT002 blocking-under-glock** — inside a ``with ..._glock:`` block:
  no ``time.sleep``, no ``.wait(...)``/``.join(...)``/``.acquire(...)``,
  and no nested ``with`` on another lock. ``_glock`` is a leaf lock
  guarding dict lookups; blocking under it stalls every shard.
* **LNT003 bare-except** — ``except:`` swallows ``KeyboardInterrupt`` and
  ``SystemExit``; name the exception.
* **LNT004 mutable-default** — list/dict/set literals (or constructor
  calls) as parameter defaults are shared across calls.
* **LNT005 shard-lock-contract** — any function taking a parameter
  annotated ``_ColonyShard``/``_CfsShard`` (or any ``*Shard``) mutates
  shard state and must declare ``@requires_lock(...)``; the runtime
  detector then enforces the declaration.
"""

from __future__ import annotations

import ast
import os
import sys

DEFAULT_PATHS = ("src/repro_torch",)

_BLOCKING_ATTRS = {"wait", "join", "acquire"}


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
    """Best-effort dotted name of an expression ('self._glock', 'time.sleep')."""
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _mentions_glock(node: ast.AST) -> bool:
    return any(
        (isinstance(n, ast.Attribute) and n.attr == "_glock")
        or (isinstance(n, ast.Name) and n.id == "_glock")
        for n in ast.walk(node)
    )


def _decorator_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    out = set()
    for d in fn.decorator_list:
        name = _dotted(d)
        out.add(name.rsplit(".", 1)[-1])
    return out


def _annotation_name(ann: ast.AST | None) -> str:
    if ann is None:
        return ""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value  # from __future__ import annotations keeps strings rare
    return _dotted(ann)


def _iter_args(fn: ast.FunctionDef | ast.AsyncFunctionDef):
    a = fn.args
    yield from a.posonlyargs
    yield from a.args
    yield from a.kwonlyargs


def _check_kv_list(tree: ast.Module, path: str, out: list[Violation]) -> None:
    # Map every node to its enclosing function name to exempt migrations.
    def visit(node: ast.AST, fname: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fname = node.name
        for child in ast.iter_child_nodes(node):
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and child.func.attr == "kv_list"
                and not fname.startswith("_migrate")
            ):
                out.append(
                    Violation(
                        path,
                        child.lineno,
                        "LNT001",
                        "kv_list is a full-table scan; use an indexed table"
                        " (allowed only inside _migrate* functions)",
                    )
                )
            visit(child, fname)

    visit(tree, "<module>")


def _check_glock_blocking(tree: ast.Module, path: str, out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        if not any(_mentions_glock(item.context_expr) for item in node.items):
            continue
        for inner in node.body:
            for sub in ast.walk(inner):
                if isinstance(sub, ast.Call):
                    name = _dotted(sub.func)
                    leaf = name.rsplit(".", 1)[-1]
                    if name == "time.sleep" or leaf in _BLOCKING_ATTRS:
                        out.append(
                            Violation(
                                path,
                                sub.lineno,
                                "LNT002",
                                f"{name or leaf}() under _glock: the registry"
                                " lock is a leaf and must never block",
                            )
                        )
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        name = _dotted(item.context_expr)
                        if name.endswith(".lock") or name.endswith("colony_lock"):
                            out.append(
                                Violation(
                                    path,
                                    sub.lineno,
                                    "LNT002",
                                    f"acquiring {name} under _glock: _glock is"
                                    " a leaf lock (see TORCH_CONTRACTS.md)",
                                )
                            )


def _check_bare_except(tree: ast.Module, path: str, out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            out.append(
                Violation(
                    path,
                    node.lineno,
                    "LNT003",
                    "bare except swallows KeyboardInterrupt/SystemExit;"
                    " name the exception",
                )
            )


def _check_mutable_defaults(tree: ast.Module, path: str, out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for d in defaults:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set")
            )
            if bad:
                out.append(
                    Violation(
                        path,
                        d.lineno,
                        "LNT004",
                        f"mutable default argument in {node.name}() is shared"
                        " across calls",
                    )
                )


def _check_shard_contracts(tree: ast.Module, path: str, out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        shard_args = [
            a.arg
            for a in _iter_args(node)
            if _annotation_name(a.annotation).rsplit(".", 1)[-1].endswith("Shard")
        ]
        if shard_args and "requires_lock" not in _decorator_names(node):
            out.append(
                Violation(
                    path,
                    node.lineno,
                    "LNT005",
                    f"{node.name}() takes shard argument"
                    f" {shard_args[0]!r} (lock-guarded mutable state) but"
                    " declares no @requires_lock contract",
                )
            )


def lint_source(src: str, path: str) -> list[Violation]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, "LNT000", f"syntax error: {e.msg}")]
    out: list[Violation] = []
    _check_kv_list(tree, path, out)
    _check_glock_blocking(tree, path, out)
    _check_bare_except(tree, path, out)
    _check_mutable_defaults(tree, path, out)
    _check_shard_contracts(tree, path, out)
    return out


def _py_files(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, _dirs, names in os.walk(p):
                files.extend(
                    os.path.join(root, n) for n in names if n.endswith(".py")
                )
    return sorted(files)


def run(paths: list[str] | None = None) -> tuple[int, list[Violation]]:
    if not paths:
        paths = [p for p in DEFAULT_PATHS if os.path.exists(p)]
    files = _py_files(paths)
    violations: list[Violation] = []
    for f in files:
        with open(f, "r", encoding="utf-8") as fh:
            violations.extend(lint_source(fh.read(), f))
    return len(files), violations


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    nfiles, vs = run(args)
    for v in vs:
        print(v)
    if vs:
        print(f"repro_torch.analysis.lint: {len(vs)} violation(s) in {nfiles} files")
        return 1
    print(f"repro_torch.analysis.lint: OK ({nfiles} files clean)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
