"""The contract linter (tools/check_static.py, unedited) over the port.

Every pass runs on ``paddle_tpu_torch/`` and must report zero
unsuppressed findings. Three attributes the port adds beside the
reference's are derived state that the linter cannot tell from state a
crash loses; they join ``SNAPSHOT_ATTR_ALLOW`` here, in memory, each with
its reason, and each entry must be load-bearing. Mutation spot-checks on
copies of the port's fleet sources show that the journal-coverage pass,
the Router leg of the snapshot pass (every ``_RouterReq`` field rebuilt
by ``Router.recover``), the supervisor's snapshot fields and the session
transport's clock purity engage on the port.
"""
import os

import pytest

from tools import check_static as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")
INF = os.path.join(PORT, "inference")

# the port's derived attributes (none is state a crash loses)
PORT_ALLOW = {
    "MoeServingCore": {
        "_block_experts": "memo of the per-m-block expert ids for a "
                          "capacity padding (torch.arange on the core's "
                          "device), rebuilt on first use after a "
                          "restore",
    },
    "PagedKVCache": {
        "_route_memo": "the last model call's routing, reused by every "
                       "layer of that call; cleared by "
                       "_tables_dirty(), which restore runs",
    },
    "PagedServingEngine": {
        "dtype": "the constructor's pool dtype; snapshot() serializes "
                 "it canonically as config.dtype from the pool's "
                 "dtype_name (a torch.dtype would not pass the "
                 "snapshot loader's allowlist) and restore() passes "
                 "it back to the constructor",
    },
}


@pytest.fixture
def port_allow(monkeypatch):
    for cls, extra in PORT_ALLOW.items():
        monkeypatch.setitem(cs.SNAPSHOT_ATTR_ALLOW, cls,
                            dict(cs.SNAPSHOT_ATTR_ALLOW.get(cls, {}),
                                 **extra))


def _run(root, passes=None):
    kept, _, problems, n = cs.run_passes(root, passes)
    assert not problems, problems
    assert n > 0
    return kept


def test_port_has_zero_findings(port_allow):
    kept, _, problems, n = cs.run_passes(PORT)
    assert not problems, problems
    assert n > 50                       # the walker saw the package
    assert kept == [], "\n".join(repr(f) for f in kept)


def test_without_the_port_allowlist_the_three_findings_show():
    """What the allowlist settles: exactly the three derived attributes
    of the port's own code."""
    kept = _run(INF, ["snapshot-completeness"])
    assert sorted(f.msg.split(" is ")[0] for f in kept) == sorted(
        f"{c}.{a}" for c, attrs in PORT_ALLOW.items() for a in attrs)


def test_port_allowlist_entries_are_load_bearing(port_allow):
    files, _ = cs.walk_files(INF)
    p = cs.SnapshotCompleteness()
    assert p.run(files) == []
    for cls, attrs in PORT_ALLOW.items():
        for attr in attrs:
            allow = cs.SNAPSHOT_ATTR_ALLOW[cls]
            saved = allow.pop(attr)
            try:
                kept = p.run(files)
            finally:
                allow[attr] = saved
            assert any(f"{cls}.{attr} " in f.msg for f in kept), \
                f"{cls}.{attr} is allowlisted but never flagged"


def test_fleet_contract_carriers_are_seen():
    files, _ = cs.walk_files(INF)
    jc = cs.JournalCoverage()
    kinds = {sf.base: set(jc._written_kinds(sf)) for sf in files}
    assert {"submit", "emit", "tick", "delivered", "release", "respawn",
            "rebalance", "net"} <= kinds["router.py"]
    snap = {c.name for sf in files for c in sf.classes()
            if {"snapshot", "restore"} <= set(cs.methods_of(c))}
    assert "FleetSupervisor" in snap


# (file, anchor, replacement, pass, line anchor, word in the message)
MUTATIONS = {
    "respawn replay handler": (
        "router.py", 'kind == "respawn"', 'kind == "respawn_zzz"',
        "journal-coverage", 'self._jrec("respawn"', "'respawn'"),
    "net replay handler": (
        "router.py", 'kind == "net"', 'kind == "net_zzz"',
        "journal-coverage", 'self._jrec("net"', "'net'"),
    "Router.recover drops steps_used": (
        "router.py", "req.steps_used += 1\n            elif",
        "pass\n            elif", "snapshot-completeness",
        "self.steps_used = 0", "steps_used"),
    "supervisor snapshot field": (
        "fleet.py", '"respawn_counts": dict(self.respawn_counts),', "",
        "snapshot-completeness", "self.respawn_counts: Dict",
        "respawn_counts"),
    "session transport clock import": (
        "net.py", "import select as _select",
        "import select as _select\nimport time as _clock",
        "net-clock-purity", "import time as _clock", "imports time"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutated_port_copy_flips_red(case, tmp_path, port_allow):
    """Each contract site deleted from a COPY of the port's source is
    flagged at the right line."""
    name, old, new, pass_id, anchor, word = MUTATIONS[case]
    with open(os.path.join(INF, name)) as f:
        text = f.read()
    assert text.count(old) == 1, f"mutation anchor gone: {old!r}"
    path = tmp_path / name
    path.write_text(text.replace(old, new))
    kept = _run(str(tmp_path), [pass_id])
    line = next(i for i, ln in enumerate(
        path.read_text().splitlines(), 1) if anchor in ln)
    assert [(f.path, f.line) for f in kept] == [(str(path), line)]
    assert word in kept[0].msg
