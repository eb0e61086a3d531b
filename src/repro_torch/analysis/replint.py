"""Replication-safety lint: the apply cone must be deterministic
(stdlib ``ast`` only).

A copy of the reference's ``repro/analysis/replint.py`` with its rules
unchanged. Run as ``python -m repro_torch.analysis.replint [paths...]``
(default: ``src/repro_torch``). Exits non-zero on any violation; there
is no suppression mechanism — rules are written so the repo passes with
zero exceptions, and a new violation means the code (not the lint)
should change.

The paper's HA deployment (§3.4.1, Fig. 3) serializes broker mutations
through a Raft log; replicas stay interchangeable across failover only
if every applied op is **deterministic** (same entry ⇒ same state on
every node) and **idempotent** (replay ⇒ no-op). This lint computes the
**apply cone** — every function reachable from a replicated-op apply
handler (the ``apply`` qualnames in the ``REPLICATED_OPS`` literal in
``broker/cluster.py``, plus any method named ``_apply``) — and proves the
cone free of divergence sources, interprocedurally to a fixpoint like
``authlint``.

Rules:

* **REP001 nondeterministic-call** — the cone calls a wall-clock or
  randomness source (``time.*``, ``now_ns``, ``random.*``, ``uuid4``,
  ``new_id``, ``os.urandom``, ...). Nondeterministic values must be
  fixed *before* the Raft log as leader-stamped entry fields, the way
  ``apply_assign`` reads ``op["ts"]`` instead of calling ``now_ns()``.
* **REP002 unordered-iteration** — a loop over an unordered collection
  (``set(...)``, ``.values()`` / ``.keys()`` / ``.items()`` not wrapped
  in ``sorted``) whose body issues a database write: iteration order
  would flow into replicated state. (Python dicts preserve insertion
  order, but insertion order itself differs across replicas that
  observed events in different sequences — only sorted iteration is
  replay-stable.)
* **REP003 unguarded-mutation** — a ``self.db`` / ``self._db`` write in
  the cone that is not CAS-guarded: the call must sit inside a
  ``colony_lock`` ``with`` block with a ``.state`` compare lexically
  before it, or (for helpers) the helper must carry its own ``.state``
  compare and be called from the cone only inside such guarded blocks.
  The CAS is what turns a Raft replay into a clean conflict instead of
  a double mutation.
* **REP004 unstamped-propose** — a ``propose`` / ``propose_and_wait`` /
  ``_propose_*`` call site whose entry resolves to a dict literal
  missing a leader-stamped ``ts`` or a stable ``opid``: the apply would
  have to improvise them per replica. Bare-parameter forwarding (a
  propose wrapper passing its own argument through) is exempt — the
  stamping obligation sits with whoever builds the literal.
* **REP005 environment-dependence** — the cone reads ``os.environ`` /
  ``os.getenv``, opens files, spawns threads or subprocesses, or
  touches sockets: replica-local context that has no place in a
  replicated state transition.

Static limitations (documented, deliberate): the call graph is
name-keyed on bare method names — ``self.db.X`` / ``self._db.X``
resolves only into ``*Database*`` classes, ``self.X`` prefers the
caller's own class, anything else joins every definition of that name
except builtin-colliding leaves (``.get``, ``.items``, ...) which never
create edges — and constructor bodies are not followed. The runtime half
(:mod:`repro_torch.analysis.statehash` under ``REPRO_REPL_CHECK=1``) catches
what static analysis cannot: journal cross-checks between replicas and
the double-apply idempotence harness.
"""

from __future__ import annotations

import ast
import os
import sys

DEFAULT_PATHS = ("src/repro_torch",)

# REP001: wall-clock / randomness sources. Dotted prefixes catch module
# calls (time.time, random.random, uuid.uuid4, secrets.token_hex);
# leaves catch the repo's own wrappers and bound-method forms.
NONDET_PREFIXES = ("time.", "random.", "uuid.", "secrets.", "os.urandom")
NONDET_LEAVES = frozenset(
    {
        "now_ns",
        "new_id",
        "token_hex",
        "token_bytes",
        "urandom",
        "uuid4",
        "getrandbits",
        "randint",
        "random",
        "choice",
        "shuffle",
        "monotonic",
        "monotonic_ns",
        "time_ns",
        "perf_counter",
    }
)

# REP002/REP003: database writes observable by other replicas.
DB_MUTATORS = frozenset(
    {
        "add_process",
        "update_process",
        "requeue",
        "delete_process",
        "user_put",
        "cron_put",
        "generator_put",
        "cfs_add_file",
        "cfs_remove_file",
        "cfs_create_snapshot",
        "cfs_remove_snapshot",
        "_write_process",
        "_exec",
        "executemany",
    }
)

# REP004: proposal entry points.
PROPOSE_LEAVES = frozenset({"propose", "propose_and_wait"})

# REP005: replica-local environment / IO.
ENV_PREFIXES = (
    "os.environ",
    "os.getenv",
    "subprocess.",
    "socket.",
    "threading.Thread",
)
ENV_LEAVES = frozenset({"getenv", "open", "Thread", "Popen", "input"})

# Leaves that collide with builtin container/str methods: ``x.get(...)``
# on a dict must not resolve into some class's ``def get``. Calls with
# these leaves never create interprocedural edges (a genuine helper
# behind one of these names would need an unambiguous name anyway).
GENERIC_LEAVES = frozenset(
    {
        "get",
        "items",
        "keys",
        "values",
        "append",
        "extend",
        "pop",
        "popleft",
        "add",
        "discard",
        "remove",
        "clear",
        "copy",
        "update",
        "setdefault",
        "sort",
        "split",
        "rsplit",
        "join",
        "strip",
        "format",
        "encode",
        "decode",
    }
)


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


# ---------------------------------------------------------------------------
# REPLICATED_OPS literal (shared with replmap)
# ---------------------------------------------------------------------------


def _literal(node: ast.AST):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


def collect_ops(sources: list[tuple[str, str]]) -> dict[str, dict]:
    """Parse the ``REPLICATED_OPS`` dict literal out of the sources.

    The matrix is data, not code — keeping it a pure literal means the
    lint, the doc generator, and the cluster dispatch all read the same
    single source of truth.
    """
    for path, src in sources:
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            else:
                continue
            if isinstance(target, ast.Name) and target.id == "REPLICATED_OPS":
                ops = _literal(value)
                if isinstance(ops, dict):
                    return ops
    return {}


# ---------------------------------------------------------------------------
# Per-function scan
# ---------------------------------------------------------------------------


class _Call:
    """One call site, with enough context for every REP rule."""

    __slots__ = ("dotted", "leaf", "base", "line", "in_guard", "node")

    def __init__(self, dotted: str, line: int, in_guard: bool, node: ast.Call) -> None:
        self.dotted = dotted
        parts = dotted.split(".")
        self.leaf = parts[-1]
        self.base = ".".join(parts[:-1])
        self.line = line
        self.in_guard = in_guard
        self.node = node


class _FnScan:
    """Ordered single-pass scan of one function body.

    Tracks, lexically: calls (with whether each sits inside a
    ``colony_lock`` ``with``), ``.state`` compares, unordered loops with
    db writes in their bodies, and dict-literal assignments (for REP004
    entry resolution).
    """

    def __init__(self, fn, classname: str, path: str) -> None:
        self.fn = fn
        self.name = fn.name
        self.classname = classname
        self.path = path
        self.params = {
            a.arg
            for a in (
                list(fn.args.posonlyargs)
                + list(fn.args.args)
                + list(fn.args.kwonlyargs)
            )
        }
        self.calls: list[_Call] = []
        self.state_cmp_lines: list[int] = []
        self.unordered_writes: list[tuple[int, str]] = []  # (line, iter repr)
        self.env_reads: list[tuple[str, int]] = []  # non-call os.environ use
        self.dicts: dict[str, ast.Dict] = {}
        self._guard_depth = 0
        for stmt in fn.body:
            self._visit(stmt)

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _is_unordered_iter(node: ast.AST) -> str | None:
        """Name the unordered source iterated over, or None if ordered."""
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            leaf = d.split(".")[-1]
            if d == "sorted":
                return None  # sorted(...) makes any source replay-stable
            if d == "set" or leaf in ("values", "keys", "items"):
                return d
        return None

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            self._visit(node.value)
            if isinstance(node.value, ast.Dict):
                self.dicts[node.targets[0].id] = node.value
            return
        if isinstance(node, ast.With):
            guard = any(
                _dotted(item.context_expr).endswith("colony_lock")
                for item in node.items
            )
            for item in node.items:
                self._visit(item.context_expr)
            if guard:
                self._guard_depth += 1
            for stmt in node.body:
                self._visit(stmt)
            if guard:
                self._guard_depth -= 1
            return
        if isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            if any(
                isinstance(o, ast.Attribute) and o.attr == "state" for o in operands
            ):
                self.state_cmp_lines.append(node.lineno)
            for child in ast.iter_child_nodes(node):
                self._visit(child)
            return
        if isinstance(node, (ast.For, ast.comprehension)):
            it = node.iter
            src = self._is_unordered_iter(it)
            body = node.body if isinstance(node, ast.For) else []
            if src is not None and self._body_writes(body):
                self.unordered_writes.append((node.lineno, src))
            for child in ast.iter_child_nodes(node):
                self._visit(child)
            return
        if isinstance(node, ast.Call):
            for arg in node.args:
                self._visit(arg)
            for kw in node.keywords:
                self._visit(kw.value)
            d = _dotted(node.func)
            if d:
                self.calls.append(_Call(d, node.lineno, self._guard_depth > 0, node))
            return
        if isinstance(node, ast.Attribute):
            d = _dotted(node)
            if d.startswith("os.environ"):
                self.env_reads.append((d, node.lineno))
            self._visit(node.value)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    @staticmethod
    def _body_writes(body: list[ast.stmt]) -> bool:
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    if _dotted(node.func).split(".")[-1] in DB_MUTATORS:
                        return True
        return False

    def state_cmp_before(self, line: int) -> bool:
        return any(l < line for l in self.state_cmp_lines)


# ---------------------------------------------------------------------------
# Whole-tree analysis
# ---------------------------------------------------------------------------


def _is_db_base(base: str) -> bool:
    return base.endswith(".db") or base.endswith("._db") or base in ("db", "_db")


class _Index:
    """All scanned functions, keyed for name-based call resolution."""

    def __init__(self) -> None:
        self.by_name: dict[str, list[_FnScan]] = {}
        self.by_class: dict[tuple[str, str], _FnScan] = {}

    def add(self, scan: _FnScan) -> None:
        self.by_name.setdefault(scan.name, []).append(scan)
        self.by_class[(scan.classname, scan.name)] = scan

    def resolve(self, caller: _FnScan, call: _Call) -> list[_FnScan]:
        if _is_db_base(call.base):
            return [
                s
                for s in self.by_name.get(call.leaf, ())
                if "Database" in s.classname
            ]
        if call.base == "self":
            own = self.by_class.get((caller.classname, call.leaf))
            if own is not None:
                return [own]
        if call.leaf in GENERIC_LEAVES:
            return []
        return self.by_name.get(call.leaf, [])


def analyze(sources: list[tuple[str, str]]) -> tuple[set[str], list[Violation]]:
    """Lint (path, source) pairs together; returns (cone names, violations)."""
    out: list[Violation] = []
    index = _Index()
    for path, src in sources:
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            out.append(
                Violation(path, e.lineno or 0, "REP000", f"syntax error: {e.msg}")
            )
            continue
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    index.add(_FnScan(fn, cls.name, path))

    ops = collect_ops(sources)
    root_names = {"_apply"} | {
        spec["apply"].rsplit(".", 1)[-1]
        for spec in ops.values()
        if isinstance(spec, dict) and isinstance(spec.get("apply"), str)
    }

    # Apply cone: closure over resolved call edges from the roots.
    cone: set[int] = set()
    cone_scans: list[_FnScan] = []
    work = [
        s for name in sorted(root_names) for s in index.by_name.get(name, ())
    ]
    while work:
        scan = work.pop()
        if id(scan) in cone:
            continue
        cone.add(id(scan))
        cone_scans.append(scan)
        for call in scan.calls:
            work.extend(index.resolve(scan, call))

    # Cone call-sites per callee (REP003 helper discharge).
    callee_sites: dict[int, list[tuple[_FnScan, _Call]]] = {}
    for scan in cone_scans:
        for call in scan.calls:
            for target in index.resolve(scan, call):
                if id(target) in cone:
                    callee_sites.setdefault(id(target), []).append((scan, call))

    cone_names = {f"{s.classname}.{s.name}" for s in cone_scans}

    for scan in cone_scans:
        _check_cone_fn(scan, callee_sites, out)

    # REP004 applies everywhere a proposal is made, cone or not.
    for scans in index.by_name.values():
        for scan in scans:
            _check_proposes(scan, out)

    return cone_names, out


def _check_cone_fn(
    scan: _FnScan,
    callee_sites: dict[int, list[tuple[_FnScan, _Call]]],
    out: list[Violation],
) -> None:
    where = f"{scan.classname}.{scan.name}"
    for call in scan.calls:
        d, leaf = call.dotted, call.leaf
        if d.startswith(NONDET_PREFIXES) or leaf in NONDET_LEAVES:
            out.append(
                Violation(
                    scan.path,
                    call.line,
                    "REP001",
                    f"{where}: nondeterministic call {d}() in the apply cone —"
                    " stamp the value into the proposed entry on the leader"
                    " (the way apply_assign reads op[\"ts\"])",
                )
            )
        if d.startswith(ENV_PREFIXES) or (
            leaf in ENV_LEAVES and (call.base == "" or d.startswith(ENV_PREFIXES))
        ):
            out.append(
                Violation(
                    scan.path,
                    call.line,
                    "REP005",
                    f"{where}: {d}() depends on replica-local environment/IO"
                    " inside the apply cone",
                )
            )
        if leaf in DB_MUTATORS and _is_db_base(call.base):
            guarded = call.in_guard and scan.state_cmp_before(call.line)
            if not guarded:
                # Helper discharge: own CAS compare + only guarded call-sites.
                # Self-recursive sites inherit the entry guard and are
                # judged by the external callers instead.
                sites = [
                    site
                    for caller, site in callee_sites.get(id(scan), [])
                    if caller is not scan
                ]
                discharged = (
                    scan.state_cmp_before(call.line)
                    and sites
                    and all(site.in_guard for site in sites)
                )
                if not discharged:
                    out.append(
                        Violation(
                            scan.path,
                            call.line,
                            "REP003",
                            f"{where}: db.{leaf} in the apply cone is not"
                            " CAS-guarded (needs a .state compare inside a"
                            " colony_lock block — replay idempotence)",
                        )
                    )
    for d, line in scan.env_reads:
        out.append(
            Violation(
                scan.path,
                line,
                "REP005",
                f"{where}: {d} read depends on replica-local environment"
                " inside the apply cone",
            )
        )
    for line, src in scan.unordered_writes:
        out.append(
            Violation(
                scan.path,
                line,
                "REP002",
                f"{where}: iteration over unordered {src}() flows into a"
                " database write — wrap the source in sorted(...) so replay"
                " order is stable",
            )
        )


def _check_proposes(scan: _FnScan, out: list[Violation]) -> None:
    where = f"{scan.classname}.{scan.name}"
    for call in scan.calls:
        if not (call.leaf in PROPOSE_LEAVES or call.leaf.startswith("_propose")):
            continue
        entry = _entry_literal(scan, call.node)
        if entry is None:
            continue  # forwarded parameter / opaque value: obligation upstream
        keys = {
            k.value
            for k in entry.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        }
        missing = sorted({"opid", "ts"} - keys)
        if missing:
            out.append(
                Violation(
                    scan.path,
                    call.line,
                    "REP004",
                    f"{where}: {call.dotted}() entry lacks leader-stamped"
                    f" field(s) {missing} — every replicated entry carries a"
                    " stable opid and a stamped ts",
                )
            )


def _entry_literal(scan: _FnScan, node: ast.Call) -> ast.Dict | None:
    """Resolve the proposed-entry argument to a dict literal, if possible."""
    for arg in reversed(node.args):
        if isinstance(arg, ast.Dict):
            return arg
        if isinstance(arg, ast.Name):
            if arg.id in scan.dicts:
                return scan.dicts[arg.id]
            return None  # parameter or opaque local — exempt
    return None


# ---------------------------------------------------------------------------
# CLI (style of repro_torch.analysis.lint / authlint)
# ---------------------------------------------------------------------------


def lint_source(src: str, path: str) -> list[Violation]:
    """Single-source convenience (rule fixtures in tests)."""
    _cone, vs = analyze([(path, src)])
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


def run(paths: list[str] | None = None) -> tuple[int, set[str], list[Violation]]:
    if not paths:
        paths = [p for p in DEFAULT_PATHS if os.path.exists(p)]
    files = _py_files(paths)
    sources = []
    for f in files:
        with open(f, "r", encoding="utf-8") as fh:
            sources.append((f, fh.read()))
    cone, vs = analyze(sources)
    return len(files), cone, vs


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    nfiles, cone, vs = run(args)
    for v in vs:
        print(v)
    if vs:
        print(
            f"repro_torch.analysis.replint: {len(vs)} violation(s) in {nfiles} files"
            f" ({len(cone)} functions in the apply cone)"
        )
        return 1
    print(
        f"repro_torch.analysis.replint: OK ({nfiles} files clean,"
        f" {len(cone)} functions in the apply cone verified deterministic)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
