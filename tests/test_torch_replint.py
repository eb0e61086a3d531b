"""The static and journal half of ``tests/test_replication.py`` on the
port's analysis plane: ``replint``'s rules fire on seeded fixtures at the
reference's rule and line, both trees lint as the reference's replint
lints them, the port's apply cone is the reference's (and the abstract
``Database.requeue`` the port declares), its replicated-op
matrix is the reference's and ``TORCH_CONTRACTS.md`` holds it; then the
digests and journals of ``repro_torch.analysis.statehash``."""

import os
import time

import pytest

from repro.analysis import replint as ref_replint
from repro.analysis import replmap as ref_replmap
from repro.core.cluster import REPLICATED_OPS as REF_REPLICATED_OPS
from repro_torch.analysis import replint, replmap, statehash
from repro_torch.analysis.statehash import (
    ClusterJournal,
    ColonyDigest,
    ReplicationDivergenceError,
    full_colony_digest,
)
from repro_torch.broker import MemoryDatabase, standalone_server
from repro_torch.broker.cluster import REPLICATED_OPS
from repro_torch.broker.raft import ThreadedRaftCluster
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.executor import ExecutorBase

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SEEDED = {
    "rep001-interprocedural": '''
import time
class C:
    def _apply(self, nid, entry, index):
        self.helper(entry)
    def helper(self, entry):
        return time.time()
''',
    "rep001-wrappers": '''
class C:
    def _apply(self, nid, entry, index):
        entry["ts"] = now_ns()
        entry["opid"] = new_id()
''',
    "rep002-unordered": '''
class C:
    def _apply(self, nid, entry, index):
        for k, v in self.index.items():
            self.db.update_process(v)
''',
    "rep002-sorted": '''
class C:
    def _apply(self, nid, entry, index):
        for k, v in sorted(self.index.items()):
            self.db.update_process(v)
''',
    "rep003-unguarded": '''
class C:
    def _apply(self, nid, entry, index):
        p = self.db.get_process(entry["processid"])
        self.db.update_process(p)
''',
    "rep003-cas": '''
class C:
    def _apply(self, nid, entry, index):
        with self.db.colony_lock("dev"):
            p = self.db.get_process(entry["processid"])
            if p.state != "waiting":
                raise ConflictError("gone")
            self.db.update_process(p)
''',
    "rep004-unstamped": '''
class C:
    def go(self):
        self.raft.propose_and_wait("n0", {"op": "assign", "processid": "p"})
''',
    "rep004-forwarding": '''
class C:
    def forward(self, entry):
        self.raft.propose_and_wait("n0", entry)
''',
    "rep005-environ": '''
import os
class C:
    def _apply(self, nid, entry, index):
        return os.environ["HOME"]
''',
    "rep005-open": '''
class C:
    def _apply(self, nid, entry, index):
        with open("/tmp/x") as f:
            return f.read()
''',
}
# (rule, how many times it must fire); None: it must not fire
WANT = {"rep001-interprocedural": ("REP001", 1), "rep001-wrappers": ("REP001", 2),
        "rep002-unordered": ("REP002", 1), "rep002-sorted": ("REP002", None),
        "rep003-unguarded": ("REP003", 1), "rep003-cas": ("REP003", None),
        "rep004-unstamped": ("REP004", 1), "rep004-forwarding": ("REP004", None),
        "rep005-environ": ("REP005", 1), "rep005-open": ("REP005", 1)}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_replint_flags_each_seeded_rule_as_the_reference_does(name):
    got = replint.lint_source(SEEDED[name], "fixture.py")
    rule, n = WANT[name]
    fired = [v for v in got if v.rule == rule]
    assert (not fired) if n is None else len(fired) >= n
    if name == "rep004-unstamped":
        assert "opid" in fired[0].msg and "ts" in fired[0].msg
    ref = ref_replint.lint_source(SEEDED[name], "fixture.py")
    assert [(v.rule, v.line) for v in got] == [(v.rule, v.line) for v in ref]


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch"])
def test_replint_matches_the_reference_on_both_trees(tree):
    path = os.path.join(ROOT, tree)
    n, cone, vs = replint.run([path])
    n_ref, cone_ref, vs_ref = ref_replint.run([path])
    assert n == n_ref > 50
    assert cone == cone_ref
    assert [(v.path, v.rule, v.line) for v in vs] == [(v.path, v.rule, v.line) for v in vs_ref]


def test_port_tree_lints_clean_with_the_references_apply_cone(monkeypatch):
    """The port's cone is the reference's, name for name, and the abstract
    ``Database.requeue`` the port declares (the reference's base class has
    none); it spans the close cascade."""
    monkeypatch.chdir(ROOT)
    nfiles, cone, vs = replint.run()
    assert vs == [], [str(v) for v in vs]
    assert nfiles > 80
    for member in ("HAColonyCluster._apply", "ColoniesServer.apply_assign",
                   "ColoniesServer.apply_close", "ColoniesServer.close_process",
                   "ColoniesServer._fail_descendants"):
        assert member in cone, member
    _n, ref_cone, _vs = ref_replint.run([os.path.join(ROOT, "src", "repro")])
    assert cone ^ ref_cone == {"Database.requeue"}
    assert replint.main([]) == 0


def test_replicated_ops_literal_is_the_references():
    assert REPLICATED_OPS == REF_REPLICATED_OPS
    with open(os.path.join(ROOT, "src", "repro_torch", "broker", "cluster.py"),
              encoding="utf-8") as fh:
        assert replint.collect_ops([("cluster.py", fh.read())]) == REPLICATED_OPS


def test_replmap_matches_torch_contracts_md_and_the_reference(monkeypatch):
    monkeypatch.chdir(ROOT)
    assert replmap.CONTRACTS_MD == "TORCH_CONTRACTS.md"
    assert replmap.main(["--check"]) == 0
    with open("TORCH_CONTRACTS.md", encoding="utf-8") as fh:
        _head, section, _tail = replmap._split(fh.read())
    assert section.strip() == replmap.generate(["src/repro_torch"]).strip()
    rows = [r for r in section.splitlines() if r.startswith("| `")]
    assert rows == [r for r in ref_replmap.generate(["src/repro"]).splitlines()
                    if r.startswith("| `")]
    assert ref_replmap.main(["--check"]) == 0


# ---------------------------------------------------------------------------
# statehash: digests and journals
# ---------------------------------------------------------------------------


def test_colony_digest_is_incremental_and_order_independent():
    rows = [
        ("p1", "waiting", "", 0, False, True, 0, 0),
        ("p2", "running", "ex1", 1, False, False, 10, 0),
        ("p3", "successful", "ex2", 0, False, False, 5, 9),
    ]
    fwd, rev = ColonyDigest(), ColonyDigest()
    for r in rows:
        fwd.observe(r[0], r)
    for r in reversed(rows):
        rev.observe(r[0], r)
    assert fwd.digest() == rev.digest()
    # updating one row replaces its contribution
    fwd.observe("p1", ("p1", "running", "ex9", 0, False, False, 3, 0))
    rev.observe("p1", ("p1", "running", "ex9", 0, False, False, 3, 0))
    assert fwd.digest() == rev.digest()
    before = ColonyDigest()
    for r in rows:
        before.observe(r[0], r)
    fwd.observe("p1", rows[0])  # reverting restores the digest exactly
    assert fwd.digest() == before.digest()
    fwd.forget("p3")
    two = ColonyDigest()
    for r in rows[:2]:
        two.observe(r[0], r)
    assert fwd.digest() == two.digest()


def test_incremental_digest_matches_full_recompute():
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv), MemoryDatabase())
    try:
        client = Colonies(InProcTransport([srv]))
        client.add_colony("dev", Crypto.id(colony_prv), server_prv)
        ex = ExecutorBase(client, "dev", "dg-w", "worker", colony_prvkey=colony_prv)
        spec = {"conditions": {"colonyname": "dev", "executortype": "worker"},
                "funcname": "echo", "maxexectime": 60}
        pids = [client.submit(spec, colony_prv)["processid"] for _ in range(3)]
        d = ColonyDigest()
        for item in srv.db.replica_state("dev"):
            d.observe(item[0], item)
        assert d.digest() == full_colony_digest(srv.db, "dev")
        pd = client.assign("dev", 2.0, ex.prvkey)
        client.close(pd["processid"], ["done"], ex.prvkey)
        for item in srv.db.replica_state("dev"):  # fold only the changed row
            if item[0] == pd["processid"]:
                d.observe(item[0], item)
        assert d.digest() == full_colony_digest(srv.db, "dev")
        assert len(d) == len(pids)
    finally:
        srv.stop()


def test_journal_detects_skewed_replica_at_right_index():
    j = ClusterJournal()
    entries = [{"op": "assign", "opid": f"o{i}", "ts": i} for i in range(5)]
    for i, e in enumerate(entries):
        j.record("n0", i, e, f"effect{i}")
    for i, e in enumerate(entries):  # n1 agrees up to index 2, then skews
        j.record("n1", i, e, f"effect{i}" if i != 3 else "SKEWED")
    assert j.divergence is not None
    assert "index 3" in str(j.divergence)
    with pytest.raises(ReplicationDivergenceError):
        j.check()
    assert "index 4" not in str(j.divergence)  # the first divergence is kept


def test_journal_divergent_entry_at_same_index_detected():
    j = ClusterJournal()
    j.record("n0", 0, {"op": "assign", "opid": "a"}, None)
    j.record("n1", 0, {"op": "assign", "opid": "b"}, None)
    with pytest.raises(ReplicationDivergenceError):
        j.check()


def test_journal_identical_replicas_are_clean():
    j = ClusterJournal()
    for nid in ("n0", "n1", "n2"):
        for i in range(10):
            j.record(nid, i, {"op": "assign", "opid": f"o{i}"}, f"e{i}")
    j.check()
    assert j.nodes() == ["n0", "n1", "n2"]
    assert j.entries("n0") == j.entries("n1") == j.entries("n2")


@pytest.fixture()
def repl_check():
    prev = statehash.is_enabled()
    statehash.enable(True)
    yield
    statehash.enable(prev)


def test_threaded_cluster_cross_checks_node_effects(repl_check):
    """An apply whose effect depends on which node ran it trips the
    journal cross-check on the first shared index."""
    cluster = ThreadedRaftCluster(3, lambda nid, e, i: f"state-of-{nid}", seed=7)
    assert cluster.journal is not None
    cluster.start()
    try:
        deadline = time.time() + 10
        leader = None
        while time.time() < deadline and leader is None:
            leader = cluster.leader_id()
            time.sleep(0.02)
        assert leader is not None
        with pytest.raises(ReplicationDivergenceError):
            while time.time() < deadline:
                cluster.propose_and_wait(leader, {"op": "x", "n": 1})
                time.sleep(0.05)
                cluster.check_divergence()
            raise AssertionError("divergent applies never detected")
    finally:
        cluster.stop()


def test_flag_off_means_no_journal():
    prev = statehash.is_enabled()
    statehash.enable(False)
    try:
        assert ThreadedRaftCluster(3, lambda nid, e, i: nid, seed=8).journal is None
    finally:
        statehash.enable(prev)
