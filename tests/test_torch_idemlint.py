"""The port's idempotency gate (``repro_torch.analysis.idemlint``): each
rule fires on a seeded fixture at the reference's rule and line, both
trees lint as the reference's idemlint lints them, and the port's tree
passes with every registered payloadtype classified in its
``core/idempotency.py``."""

import os

import pytest

from repro.analysis import idemlint as ref_idemlint
from repro_torch.analysis import idemlint
from repro_torch.core import idempotency

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# one handler table and a SPEC literal (only a file named idempotency.py
# holds the SPEC the lint reads)
HANDLERS = '''
class S:
    def handlers(self):
        return {"put": self._h_put, "peek": self._h_peek, "ping": self._h_ping}

    def _h_put(self, identity, payload):
        self._store(payload)

    def _store(self, payload):
        self.db.kv_put("t", payload["k"], payload)

    def _h_peek(self, identity, payload):
        return self.db.kv_get("t", payload["k"])

    def _h_ping(self, identity, payload):
        self.db.touch_executor(identity, 0)
'''
SPECS = {
    "clean": '{"put": KEYED, "peek": READ, "ping": READ}',
    "unclassified": '{"put": KEYED, "peek": READ}',  # IDM001: ping
    "mutating-read": '{"put": READ, "peek": READ, "ping": READ}',  # IDM002: put
    "stale-spec": '{"put": KEYED, "peek": READ, "ping": READ, "gone": READ}',  # IDM003
    "keyed-read-only": '{"put": KEYED, "peek": NATURAL, "ping": READ}',  # IDM004: peek
}
WANT = {"clean": [], "unclassified": ["IDM001"], "mutating-read": ["IDM002"],
        "stale-spec": ["IDM003"], "keyed-read-only": ["IDM004"]}


def _sources(spec: str) -> list[tuple[str, str]]:
    return [("server.py", HANDLERS), ("idempotency.py", f"SPEC = {spec}\n")]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_idemlint_flags_each_seeded_rule_as_the_reference_does(name):
    got = idemlint.analyze(_sources(SPECS[name]))
    assert [v.rule for v in got] == WANT[name]
    ref = ref_idemlint.analyze(_sources(SPECS[name]))
    assert [(v.path, v.rule, v.line) for v in got] == [(v.path, v.rule, v.line) for v in ref]


def test_idemlint_without_a_spec_names_the_ports_module():
    got = idemlint.analyze([("server.py", HANDLERS)])
    ref = ref_idemlint.analyze([("server.py", HANDLERS)])
    assert [(v.rule, v.line) for v in got] == [(v.rule, v.line) for v in ref] == [("IDM000", 0)]
    assert got[0].path == "src/repro_torch/core/idempotency.py"


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch"])
def test_idemlint_matches_the_reference_on_both_trees(tree):
    path = os.path.join(ROOT, tree)
    n, vs = idemlint.run([path])
    n_ref, vs_ref = ref_idemlint.run([path])
    assert n == n_ref > 50
    assert [(v.path, v.rule, v.line) for v in vs] == [(v.path, v.rule, v.line) for v in vs_ref]


def test_idemlint_port_tree_is_clean(monkeypatch):
    """With no arguments from the repo's root: the port's tree, and every
    payloadtype of its 34 handlers classified."""
    monkeypatch.chdir(ROOT)
    assert idemlint.DEFAULT_PATHS == ("src/repro_torch",)
    nfiles, vs = idemlint.run()
    assert nfiles > 80 and [str(v) for v in vs] == []
    assert len(idempotency.SPEC) == 34
    assert idemlint.main([]) == 0
