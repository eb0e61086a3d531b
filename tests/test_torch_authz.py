"""``tests/test_authz.py`` on the port's analysis plane and broker.

  * the port's authlint catches seeded broken handlers, one per AUT rule,
    at the reference's rule and line, and both trees lint as the
    reference's authlint lints them;
  * the port's permission matrix is the reference's row for row (34
    payloadtypes, no ``?``: each handler calls its own ``_require_*``) and
    ``TORCH_CONTRACTS.md`` holds it;
  * the runtime auth-fact contracts (``REPRO_AUTH_CHECK``) pass on every
    RPC of the port's broker over both databases and catch a handler that
    bypasses its check.

The reference's user-table cases are ``tests/test_torch_database.py``'s;
the port has no unverified-envelope path to harden."""

import os
import textwrap

import pytest

from repro.analysis import authlint as ref_authlint
from repro.analysis import authmap as ref_authmap
from repro_torch.analysis import authlint, authmap, authtrack, locktrack
from repro_torch.analysis.authtrack import ANY_COLONY, AuthContractError, requires_auth
from repro_torch.broker import ColoniesServer, MemoryDatabase, SqliteDatabase, standalone_server
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.security import sign_envelope
from test_torch_broker import KEYS, _script

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SEEDED = {
    # AUT001: the handler touches the db and never establishes an auth fact
    "missing-auth": """
        class S:
            def _h_peek(self, identity, payload):
                return self.db.kv_get("misc", payload["key"])
        """,
    # AUT001 through a helper: the db touch hides one call deep
    "missing-auth-helper": """
        class S:
            def _lookup(self, key):
                return self.db.kv_get("misc", key)

            def _h_peek(self, identity, payload):
                return self._lookup(payload["key"])
        """,
    # AUT002: membership verified for one colony, the db acts on another
    "confused-deputy": """
        class S:
            def _h_swap(self, identity, payload):
                self._require_member(identity, payload["colonyname"])
                return self.db.list_executors(payload["other"])
        """,
    # AUT003: both verify=False and verify_signatures=False literals
    "unverified-envelope": """
        from repro.core.security import open_envelope
        from repro.core.server import ColoniesServer

        identity, ptype, payload = open_envelope(env, verify=False)
        srv = ColoniesServer("sid", verify_signatures=False)
        """,
    # AUT004: a listing (not an id-keyed fetch) precedes the auth fact
    "fetch-before-auth": """
        class S:
            def _h_eager(self, identity, payload):
                rows = self.db.list_processes(payload["colonyname"], "waiting", 10)
                self._require_member(identity, payload["colonyname"])
                return rows
        """,
    # fetch-then-authorize: the id-keyed fetch names the colony
    "fetch-then-authorize": """
        class S:
            def _h_run(self, identity, payload):
                entry = self.db.cron_get(payload["cronid"])
                self._require_member(identity, entry["colonyname"])
                self.db.cron_put(entry)
                return entry
        """,
    # `c = payload.get("colonyname", "")` names payload["colonyname"]
    "canonical-get": """
        class S:
            def _h_list(self, identity, payload):
                c = payload.get("colonyname", "")
                self._require_member(identity, c)
                return self.db.list_executors(payload["colonyname"])
        """,
    "server-owner-any-colony": """
        class S:
            def _h_admin(self, identity, payload):
                self._require_server_owner(identity)
                return self.db.list_executors(payload["colonyname"])
        """,
}
# the rules each fixture must raise (it may raise others: the listing
# before the check also acts on a colony no check covered)
WANT = {"missing-auth": ["AUT001"], "missing-auth-helper": ["AUT001"],
        "confused-deputy": ["AUT002"], "unverified-envelope": ["AUT003", "AUT003"],
        "fetch-before-auth": ["AUT004"], "fetch-then-authorize": [], "canonical-get": [],
        "server-owner-any-colony": []}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_authlint_flags_each_seeded_rule_as_the_reference_does(name):
    src = textwrap.dedent(SEEDED[name])
    got = [(v.rule, v.line) for v in authlint.lint_source(src, "fixture.py")]
    rules = [r for r, _ in got]
    assert [r for r in rules if r in WANT[name]] == WANT[name] and (rules or not WANT[name])
    assert got == [(v.rule, v.line) for v in ref_authlint.lint_source(src, "fixture.py")]


def _handlers(hs):
    return sorted((h.classname, h.name, tuple(h.ptypes), h.role) for h in hs)


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch"])
def test_authlint_matches_the_reference_on_both_trees(tree):
    path = os.path.join(ROOT, tree)
    n, hs, vs = authlint.run([path])
    n_ref, hs_ref, vs_ref = ref_authlint.run([path])
    assert n == n_ref > 20
    assert [(v.path, v.rule, v.line) for v in vs] == [(v.path, v.rule, v.line) for v in vs_ref]
    assert _handlers(hs) == _handlers(hs_ref)


def test_authlint_port_tree_is_clean(monkeypatch):
    """With no arguments from the repo's root: the port's tree, zero
    violations, every registered handler seen and given a role."""
    monkeypatch.chdir(ROOT)
    nfiles, handlers, violations = authlint.run()
    assert violations == []
    registered = [h for h in handlers if h.ptypes]
    assert nfiles > 80 and len(registered) >= 30
    assert all(h.role for h in registered)
    assert authlint.main([]) == 0


def _rows(section: str) -> list[str]:
    return [line for line in section.splitlines() if line.startswith("| `")]


def test_permission_matrix_is_the_references_row_for_row():
    """34 payloadtypes, the same handlers and roles as the reference's, no
    ``?``: approve/reject executor and the CFS handlers call their own
    ``_require_*`` (no helper hides the check from the matrix)."""
    ours = _rows(authmap.generate([os.path.join(ROOT, "src", "repro_torch")]))
    theirs = _rows(ref_authmap.generate([os.path.join(ROOT, "src", "repro")]))
    assert len(ours) == 34 and not any("| ? |" in r for r in ours)
    assert ours == theirs


def test_authmap_matches_torch_contracts_md(monkeypatch):
    """The drift gates: the port's matrix against TORCH_CONTRACTS.md, the
    reference's against SECURITY.md, both from the repo's root."""
    monkeypatch.chdir(ROOT)
    assert authmap.CONTRACTS_MD == "TORCH_CONTRACTS.md"
    assert authmap.main(["--check"]) == 0
    assert ref_authmap.main(["--check"]) == 0


def test_authmap_refuses_failing_tree(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(SEEDED["missing-auth"]))
    with pytest.raises(SystemExit):
        authmap.generate([str(bad)])


# ---------------------------------------------------------------------------
# Runtime auth-fact contracts (REPRO_AUTH_CHECK=1)
# ---------------------------------------------------------------------------


@pytest.fixture()
def auth_checking():
    """Contracts on; restore the prior mode afterwards."""
    prev = authtrack.is_enabled()
    authtrack.enable(True)
    yield
    authtrack.enable(prev)


@pytest.fixture()
def colony():
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv))
    client = Colonies(InProcTransport([srv]))
    client.add_colony("dev", Crypto.id(colony_prv), server_prv)
    yield {"server": srv, "client": client, "server_prv": server_prv, "colony_prv": colony_prv}
    srv.stop()


def _remaining_rpcs(client: Colonies) -> None:
    """The payloadtypes ``test_torch_broker._script`` sends none of."""
    k, colony = KEYS, KEYS["colony"]
    wf = {"colonyname": "dev", "functionspecs": [
        {"nodename": "c", "funcname": "tick", "conditions": {"executortype": "edge-data",
                                                              "dependencies": []}}]}
    assert client._rpc("listfunctions", {"colonyname": "dev"}, k["user"])
    cron = client.add_cron({"colonyname": "dev", "name": "c", "interval": 3600,
                            "workflow": wf}, colony)
    assert [c["cronid"] for c in client.get_crons("dev", k["user"])] == [cron["cronid"]]
    client._rpc("runcron", {"cronid": cron["cronid"]}, k["user"])
    client.remove_cron(cron["cronid"], colony)
    g = client.add_generator({"colonyname": "dev", "name": "g", "queuesize": 5,
                              "workflow": wf}, colony)
    client.pack(g["generatorid"], {"x": 1}, k["user"])
    assert client._rpc("removegenerator", {"generatorid": g["generatorid"]}, colony)["removed"]


@pytest.mark.parametrize("db", ["memory", "sqlite"])
def test_every_rpc_runs_under_the_contracts(auth_checking, db):
    """All 34 payloadtypes of the port's broker, with the auth-fact guards
    and the lock-order detector armed: ``test_torch_broker.py``'s script
    (members, owners, executors, strangers; the failsafe; generators; CFS)
    and the five it leaves out. A handler that touched a colony without
    its fact would raise AuthContractError out of ``handle``."""
    prev = locktrack.is_enabled()
    locktrack.enable(True)
    locktrack.reset()
    try:
        srv = standalone_server(Crypto.id(KEYS["server"]),
                                MemoryDatabase() if db == "memory" else SqliteDatabase())
        seen = []
        handle = srv.handle

        def counted(envelope, *args, **kwargs):
            seen.append(envelope["payloadtype"])
            return handle(envelope, *args, **kwargs)

        srv.handle = counted
        client = Colonies(InProcTransport([srv]))
        try:
            log = _script(client, srv)
            _remaining_rpcs(client)
        finally:
            srv.stop()
        assert log[-1]["successful"] >= 6 and log[-1]["failed"] >= 4
        registered = set(srv._handlers)
        for ext in srv.extensions:
            registered |= set(ext.handlers())
        assert len(registered) == 34 and registered <= set(seen)
        assert locktrack.violations() == []
    finally:
        locktrack.reset()
        locktrack.enable(prev)


def test_bypassing_handler_raises_contract_error(colony, auth_checking):
    """A handler that skips its _require_* check dies on the db guard."""
    srv = colony["server"]
    srv._handlers["rogue"] = lambda identity, payload: srv.db.list_executors("dev")
    env = sign_envelope("rogue", {}, colony["colony_prv"])
    with pytest.raises(AuthContractError):
        srv.handle(env)


def test_wrong_colony_fact_raises_contract_error(colony, auth_checking):
    """Runtime confused deputy: authorized for dev, acted on dev2."""
    srv = colony["server"]
    colony["client"].add_colony("dev2", Crypto.id(Crypto.prvkey()), colony["server_prv"])

    def rogue(identity, payload):
        srv._require_member(identity, "dev")
        return srv.db.list_executors("dev2")

    srv._handlers["rogue"] = rogue
    env = sign_envelope("rogue", {}, colony["colony_prv"])
    with pytest.raises(AuthContractError):
        srv.handle(env)


def test_requires_auth_pins_the_role(auth_checking):
    @requires_auth("executor")
    def internal():
        return "ok"

    assert internal() == "ok"  # outside any request scope: inert
    with authtrack.request_scope():
        with pytest.raises(AuthContractError):
            internal()
        authtrack.record("id1", "dev", "member")
        with pytest.raises(AuthContractError):
            internal()  # member does not satisfy executor
        authtrack.record("id1", "dev", "executor")
        assert internal() == "ok"


def test_contracts_stand_at_the_references_sites():
    """``@requires_auth`` and ``@no_locks_held`` on the server's internals,
    as the reference's ``core/server.py`` declares them."""
    from repro.core.server import ColoniesServer as RefServer

    for name in ("submit_workflow_processes", "apply_assign", "apply_close", "close_process",
                 "assign", "failsafe_scan"):
        ours, theirs = getattr(ColoniesServer, name), getattr(RefServer, name)
        for attr in ("__auth_contract__", "__lock_contract__"):
            assert getattr(ours, attr, None) == getattr(theirs, attr, None), (name, attr)
    assert ColoniesServer.apply_close.__auth_contract__ == "executor"


@pytest.mark.parametrize("make_db", [MemoryDatabase, SqliteDatabase])
def test_every_colony_scoped_entry_point_is_guarded(make_db):
    """``Database.__init_subclass__`` wraps the 28 colony-scoped methods of
    each backend."""
    guarded = [m for m in authtrack.GUARDED_DB_METHODS
               if getattr(getattr(make_db, m), "__auth_guarded__", False)]
    assert len(guarded) == len(authtrack.GUARDED_DB_METHODS) == 28


def test_server_fact_satisfies_any_colony(auth_checking):
    with authtrack.request_scope():
        authtrack.record("srv", ANY_COLONY, "server")
        assert authtrack.has_fact("anything", "member")
        assert authtrack.has_fact("other", "owner")


@pytest.mark.parametrize("make_db", [MemoryDatabase, SqliteDatabase])
def test_guards_inert_outside_request_scope(auth_checking, make_db):
    """Background ticks and direct database use have no request identity:
    the guards must not fire there even with checking enabled."""
    db = make_db()
    db.user_put({"userid": "u1", "colonyname": "dev", "name": "n"})
    assert [u["userid"] for u in db.user_list("dev")] == ["u1"]
    with authtrack.request_scope():
        with pytest.raises(AuthContractError):
            db.user_list("dev")


def test_facts_are_request_scoped(auth_checking):
    with authtrack.request_scope():
        authtrack.record("id1", "dev", "member")
        assert authtrack.facts()
    assert authtrack.facts() == ()
