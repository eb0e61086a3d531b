"""Zero-trust authorization lint (stdlib ``ast`` only).

A copy of the reference's ``repro/analysis/authlint.py`` with its rules
unchanged. Run as ``python -m repro_torch.analysis.authlint [paths...]``
(default: ``src/repro_torch``). Exits non-zero on any violation; there
is no suppression mechanism — rules are written so the repo passes with
zero exceptions, and a new violation means the code (not the lint)
should change.

The paper's security model (§3.4.6, "never trust, always verify") makes
every RPC handler responsible for establishing an **authorization
fact** — a ``_require_member`` / ``_require_colony_owner`` /
``_require_executor`` / ``_require_server_owner`` check — before acting
on database state. This lint proves that property statically for every
``_h_*`` handler (server and extensions), interprocedurally: a handler
may delegate database work to ``self`` / ``self.server`` methods, and
per-method summaries (does it touch the db? does it establish auth?)
are propagated to a fixpoint.

Rules:

* **AUT001 missing-auth** — a registered handler (transitively) touches
  ``self.db`` / ``self._db`` but never establishes any authorization
  fact. The bypass shape: whoever signs *any* envelope gets the data.
* **AUT002 confused-deputy** — the payload-derived colony name passed to
  a database call is not one of the colony expressions that were passed
  to an auth check: the handler verified membership of colony A, then
  acted on colony B. Expressions are compared canonically (variables
  resolved through simple assignments, ``x.get("k", d)`` treated as
  ``x["k"]``); only payload-derived expressions are compared — opaque
  values (constructor results, database fetches) are out of scope.
* **AUT003 unverified-envelope** — non-test code constructs
  ``open_envelope(..., verify=False)`` or passes
  ``verify_signatures=False``. The unverified path trusts a bare
  identity *claim* and exists only for in-process benchmark harnesses
  (which live outside the linted tree).
* **AUT004 fetch-before-auth** — a database access other than an
  id-keyed fetch precedes the handler's first auth fact. Id-keyed
  fetches (``get_process``, ``cron_get``, ...) are the allowed first
  half of the fetch-then-authorize pattern — the row is needed to learn
  *which* colony to authorize against; anything else (listings, writes)
  before auth leaks data or mutates state for unauthenticated callers.

Static limitations (documented, deliberate): statements are walked
linearly through ``if``/``try`` bodies (a branch that skips the auth
check still counts as authed afterwards — the runtime contracts in
authtrack.py catch that shape), and expression canonicalization follows
single-target assignments only.
"""

from __future__ import annotations

import ast
import os
import sys

DEFAULT_PATHS = ("src/repro_torch",)

# Auth-fact helpers: name -> (role, index of the colony argument after
# identity; None = server owner, which authorizes any colony).
AUTH_FUNCS: dict[str, tuple[str, int | None]] = {
    "_require_server_owner": ("server owner", None),
    "_require_colony_owner": ("colony owner", 1),
    "_require_executor": ("executor", 1),
    "_require_member": ("member", 1),
}

# Id-keyed fetches allowed before the auth fact (fetch-then-authorize:
# the fetched row is what names the colony to authorize against).
FETCH_WHITELIST = frozenset(
    {
        "get_colony",
        "get_executor",
        "get_executor_by_name",
        "get_process",
        "cron_get",
        "generator_get",
        "user_get",
        "kv_get",
        "kv_len",
    }
)

# Database methods taking the colony name as a positional string argument.
COLONY_ARG: dict[str, int] = {
    "list_executors": 0,
    "list_functions": 0,
    "add_function": 1,
    "list_processes": 0,
    "candidates": 0,
    "colony_stats": 0,
    "user_list": 0,
    "cfs_get_file": 0,
    "cfs_get_files_by_ids": 0,
    "cfs_head": 0,
    "cfs_list": 0,
    "cfs_remove_file": 0,
    "cfs_pin_count": 0,
    "cfs_get_snapshot": 0,
    "cfs_list_snapshots": 0,
    "cfs_remove_snapshot": 0,
    "cron_list": 0,
    "generator_list": 0,
}

# Database methods taking an entry dict carrying 'colonyname'.
COLONY_ENTRY = frozenset(
    {"cfs_add_file", "cfs_create_snapshot", "cron_put", "generator_put", "user_put"}
)

_ROLE_ORDER = ("server owner", "colony owner", "executor", "member")


class Violation:
    __slots__ = ("path", "line", "rule", "msg")

    def __init__(self, path: str, line: int, rule: str, msg: str) -> None:
        self.path = path
        self.line = line
        self.rule = rule
        self.msg = msg

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


class HandlerInfo:
    """One registered RPC handler, for reports and the permission matrix."""

    __slots__ = ("path", "classname", "name", "line", "ptypes", "role")

    def __init__(self, path: str, classname: str, name: str, line: int) -> None:
        self.path = path
        self.classname = classname
        self.name = name
        self.line = line
        self.ptypes: list[str] = []
        self.role = ""


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


# ---------------------------------------------------------------------------
# Per-function event extraction
# ---------------------------------------------------------------------------

# Event tuples, in statement order:
#   ("auth", role, colony_expr, lineno)    colony_expr "*" = any colony
#   ("db", method, colony_expr|None, lineno)
#   ("call", bare_method_name, lineno)     self./self.server. method call


class _FnWalker:
    def __init__(self) -> None:
        self.env: dict[str, str] = {}
        self.dict_colony: dict[str, str] = {}
        self.events: list[tuple] = []

    # -- canonical expressions ------------------------------------------
    def canon(self, node: ast.AST) -> str:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            return self.canon(node.value) + "." + node.attr
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Constant):
                return f"{self.canon(node.value)}[{node.slice.value!r}]"
            return self.canon(node.value) + "[?]"
        if isinstance(node, ast.Constant):
            return repr(node.value)
        if isinstance(node, ast.Call):
            f = node.func
            # x.get("k", default) names the same value as x["k"].
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                return f"{self.canon(f.value)}[{node.args[0].value!r}]"
            return self.canon(f) + "()"
        if isinstance(node, ast.BoolOp):  # `colony or fallback` -> main arm
            return self.canon(node.values[0])
        return "<expr>"

    # -- ordered traversal ----------------------------------------------
    def visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            self.visit(node.value)
            name = node.targets[0].id
            if isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant) and k.value == "colonyname":
                        self.dict_colony[name] = self.canon(v)
            self.env[name] = self.canon(node.value)
            return
        if isinstance(node, ast.Call):
            for arg in node.args:
                self.visit(arg)
            for kw in node.keywords:
                self.visit(kw.value)
            self._record_call(node)
            return
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def _record_call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        parts = d.split(".")
        leaf = parts[-1]
        if leaf in AUTH_FUNCS and parts[0] == "self":
            role, idx = AUTH_FUNCS[leaf]
            if idx is None:
                expr = "*"
            elif idx < len(node.args):
                expr = self.canon(node.args[idx])
            else:
                expr = "<expr>"
            self.events.append(("auth", role, expr, node.lineno))
            return
        if len(parts) >= 3 and parts[0] == "self" and parts[-2] in ("db", "_db"):
            self.events.append(("db", leaf, self._db_colony(leaf, node), node.lineno))
            return
        if parts[0] == "self" and (
            len(parts) == 2 or (len(parts) == 3 and parts[1] == "server")
        ):
            self.events.append(("call", leaf, node.lineno))

    def _db_colony(self, method: str, node: ast.Call) -> str | None:
        if method in COLONY_ARG:
            idx = COLONY_ARG[method]
            if idx < len(node.args):
                return self.canon(node.args[idx])
            return None
        if method in COLONY_ENTRY and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Name) and arg.id in self.dict_colony:
                return self.dict_colony[arg.id]
            return self.canon(arg) + "['colonyname']"
        return None


def _fn_events(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[tuple]:
    w = _FnWalker()
    for stmt in fn.body:
        w.visit(stmt)
    return w.events


# ---------------------------------------------------------------------------
# Whole-tree analysis
# ---------------------------------------------------------------------------


class _Summary:
    __slots__ = ("touches_db", "touches_db_nonfetch", "establishes_auth", "calls")

    def __init__(self) -> None:
        self.touches_db = False
        self.touches_db_nonfetch = False
        self.establishes_auth = False
        self.calls: set[str] = set()


def _payload_derived(expr: str | None) -> bool:
    return expr is not None and "payload[" in expr


def analyze(sources: list[tuple[str, str]]) -> tuple[list[HandlerInfo], list[Violation]]:
    """Analyze (path, source) pairs together (cross-file interprocedural)."""
    out: list[Violation] = []
    # (path, classname, fn) for every method of every class; events cached.
    methods: list[tuple[str, str, ast.FunctionDef]] = []
    events: dict[int, list[tuple]] = {}
    registered: dict[str, list[str]] = {}  # handler method name -> payloadtypes

    for path, src in sources:
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            out.append(Violation(path, e.lineno or 0, "AUT000", f"syntax error: {e.msg}"))
            continue
        _check_unverified(tree, path, out)
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods.append((path, cls.name, fn))
                    events[id(fn)] = _fn_events(fn)
        # Handler-table dict literals: {"payloadtype": self._h_xxx, ...}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and isinstance(v, ast.Attribute)
                    and v.attr.startswith("_h_")
                ):
                    registered.setdefault(v.attr, []).append(k.value)

    # Per-method summaries, propagated to a fixpoint across bare names
    # (extension handlers call into the server as self.server.<method>).
    summaries: dict[str, _Summary] = {}
    for _path, _cls, fn in methods:
        s = summaries.setdefault(fn.name, _Summary())
        for ev in events[id(fn)]:
            if ev[0] == "db":
                s.touches_db = True
                if ev[1] not in FETCH_WHITELIST:
                    s.touches_db_nonfetch = True
            elif ev[0] == "auth":
                s.establishes_auth = True
            elif ev[0] == "call":
                s.calls.add(ev[1])
    changed = True
    while changed:
        changed = False
        for s in summaries.values():
            for callee in s.calls:
                c = summaries.get(callee)
                if c is None:
                    continue
                for attr in ("touches_db", "touches_db_nonfetch", "establishes_auth"):
                    if getattr(c, attr) and not getattr(s, attr):
                        setattr(s, attr, True)
                        changed = True

    # Handler checks.
    handlers: list[HandlerInfo] = []
    for path, clsname, fn in methods:
        if not fn.name.startswith("_h_"):
            continue
        info = HandlerInfo(path, clsname, fn.name, fn.lineno)
        info.ptypes = sorted(registered.get(fn.name, []))
        handlers.append(info)
        evs = events[id(fn)]

        roles = [ev[1] for ev in evs if ev[0] == "auth"]
        if roles:
            info.role = min(roles, key=_ROLE_ORDER.index)

        authed = False
        auth_exprs: set[str] = set()
        any_colony = False
        touches = False
        establishes = bool(roles)
        for ev in evs:
            if ev[0] == "auth":
                authed = True
                if ev[2] == "*":
                    any_colony = True
                else:
                    auth_exprs.add(ev[2])
            elif ev[0] == "db":
                touches = True
                _method, expr, line = ev[1], ev[2], ev[3]
                if not authed and _method not in FETCH_WHITELIST:
                    out.append(
                        Violation(
                            path,
                            line,
                            "AUT004",
                            f"{clsname}.{fn.name}: db.{_method} before any"
                            " auth fact (only id-keyed fetches may precede"
                            " authorization)",
                        )
                    )
                if (
                    _payload_derived(expr)
                    and not any_colony
                    and expr not in auth_exprs
                ):
                    out.append(
                        Violation(
                            path,
                            line,
                            "AUT002",
                            f"{clsname}.{fn.name}: db.{_method} acts on colony"
                            f" {expr} but the auth check covered"
                            f" {sorted(auth_exprs) or 'nothing'}"
                            " (confused deputy)",
                        )
                    )
            elif ev[0] == "call":
                callee = summaries.get(ev[1])
                if callee is None:
                    continue
                if callee.establishes_auth:
                    authed = True
                    establishes = True
                if callee.touches_db:
                    touches = True
                    if not authed and callee.touches_db_nonfetch:
                        out.append(
                            Violation(
                                path,
                                ev[2],
                                "AUT004",
                                f"{clsname}.{fn.name}: {ev[1]}() touches the db"
                                " before any auth fact",
                            )
                        )
        if touches and not establishes:
            out.append(
                Violation(
                    path,
                    fn.lineno,
                    "AUT001",
                    f"{clsname}.{fn.name} touches the database but never"
                    " establishes an authorization fact"
                    " (_require_member/_require_colony_owner/...)",
                )
            )
    return handlers, out


def _check_unverified(tree: ast.Module, path: str, out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _dotted(node.func)
        for kw in node.keywords:
            if not (isinstance(kw.value, ast.Constant) and kw.value.value is False):
                continue
            if kw.arg == "verify" and fname.endswith("open_envelope"):
                out.append(
                    Violation(
                        path,
                        node.lineno,
                        "AUT003",
                        "open_envelope(verify=False) trusts a bare identity"
                        " claim; only in-process test/benchmark harnesses may"
                        " do that (outside the linted tree)",
                    )
                )
            elif kw.arg == "verify_signatures":
                out.append(
                    Violation(
                        path,
                        node.lineno,
                        "AUT003",
                        f"{fname}(verify_signatures=False) disables the"
                        " zero-trust protocol; only in-process"
                        " test/benchmark harnesses may do that",
                    )
                )


# ---------------------------------------------------------------------------
# CLI (style of repro_torch.analysis.lint)
# ---------------------------------------------------------------------------


def lint_source(src: str, path: str) -> list[Violation]:
    """Single-source convenience (rule fixtures in tests)."""
    _handlers, vs = analyze([(path, src)])
    return vs


def _py_files(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in names if n.endswith(".py"))
    return sorted(files)


def run(paths: list[str] | None = None) -> tuple[int, list[HandlerInfo], list[Violation]]:
    if not paths:
        paths = [p for p in DEFAULT_PATHS if os.path.exists(p)]
    files = _py_files(paths)
    sources = []
    for f in files:
        with open(f, "r", encoding="utf-8") as fh:
            sources.append((f, fh.read()))
    handlers, vs = analyze(sources)
    return len(files), handlers, vs


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    nfiles, handlers, vs = run(args)
    for v in vs:
        print(v)
    nreg = sum(1 for h in handlers if h.ptypes)
    if vs:
        print(
            f"repro_torch.analysis.authlint: {len(vs)} violation(s) in {nfiles} files"
            f" ({nreg} registered handlers)"
        )
        return 1
    print(
        f"repro_torch.analysis.authlint: OK ({nfiles} files clean,"
        f" {nreg} registered handlers verified)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
