"""The port's gossip: ``nomad_tpu_torch.gossip`` (SWIM membership and the
AES-GCM keyring) against the JAX package's.

- (a) the keyring: a frame sealed by either package's ``Keyring`` opens in
  the other's; the same install/use/remove sequence gives equal rings and
  equal refusals; a keyring file written by one loads in the other;
- (b) membership: three port members converge to alive from one seed; a
  member stopped without leaving goes suspect, then dead, then is reaped;
- (c) the wire: a port member and a JAX member join each other and see
  each other alive, in plaintext and under one shared key, and a member
  of either package with another key never merges.

Every member is stopped in ``finally``, and a fixture checks after each
test that no thread it started is still alive within ``STOP_S``. Every
wait has a deadline.
"""

import threading
import time

import pytest

from torch_for_tests import gil_handoff  # noqa: F401

from nomad_tpu.gossip import Gossip as JGossip
from nomad_tpu.gossip import keyring as jkeyring
from nomad_tpu_torch.gossip import Gossip as TGossip
from nomad_tpu_torch.gossip import keyring as tkeyring

#: seconds a stopped member's threads get to end
STOP_S = 10.0
#: seconds a membership change gets to show
CONVERGE_S = 20.0
#: fast failure detection, so a stopped member is dead within seconds
TIMING = dict(probe_interval=0.1, ack_timeout=0.3, suspect_timeout=0.6, reap_timeout=1.5)


@pytest.fixture(autouse=True)
def _threads_end():
    """After each test, every thread it started has ended within ``STOP_S``."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + STOP_S
    while True:
        left = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, f"threads still alive {STOP_S} s after the test: {[t.name for t in left]}"


def _wait(fn, msg, timeout=CONVERGE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _alive(g) -> set:
    return {m.name for m in g.alive_members()}


# ---------------------------------------------------------------------------
# (a) the keyring
# ---------------------------------------------------------------------------

def test_frames_open_across_the_packages():
    key = tkeyring.generate_key()
    t, j = tkeyring.Keyring(key), jkeyring.Keyring(key)
    for payload in (b"", b"x", b"ping frame" * 50):
        assert j.open(t.seal(payload)) == payload
        assert t.open(j.seal(payload)) == payload
    other = jkeyring.Keyring(jkeyring.generate_key())
    assert t.open(other.seal(b"x")) is None and other.open(t.seal(b"x")) is None
    assert t.open(b"short") is None and j.open(b"short") is None


def test_ring_sequences_give_equal_rings():
    keys = [jkeyring.generate_key() for _ in range(4)]
    t, j = tkeyring.Keyring(keys[0]), jkeyring.Keyring(keys[0])
    steps = [("install", keys[1]), ("install", keys[2]), ("use", keys[1]),
             ("remove", keys[0]), ("remove", keys[1]), ("use", keys[3]),
             ("install", keys[3]), ("use", keys[3]), ("remove", keys[2]),
             ("install", "dG9vLXNob3J0")]
    for op, key in steps:
        outcome = []
        for ring in (t, j):
            try:
                getattr(ring, op)(key)
                outcome.append(None)
            except (KeyError, ValueError) as e:
                outcome.append((type(e).__name__, str(e)))
        assert outcome[0] == outcome[1], (op, outcome)
        assert t.list_keys() == j.list_keys()
    assert t.list_keys()["PrimaryKey"] == keys[3]
    for bad in ("dG9vLXNob3J0", "not base64!"):
        errs = []
        for mod in (tkeyring, jkeyring):
            with pytest.raises(Exception) as e:
                mod.Keyring(bad)
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("writer,reader", [(tkeyring, jkeyring), (jkeyring, tkeyring)])
def test_a_keyring_file_loads_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "keyring.json")
    boot, extra = writer.generate_key(), writer.generate_key()
    ring = writer.Keyring(boot, path=path)
    ring.install(extra)
    ring.use(extra)
    loaded = reader.Keyring(boot, path=path)
    assert loaded.list_keys()["PrimaryKey"] == extra
    assert set(loaded.list_keys()["Keys"]) == {boot, extra}
    assert loaded.open(ring.seal(b"before the restart")) == b"before the restart"


# ---------------------------------------------------------------------------
# (b) membership
# ---------------------------------------------------------------------------

def test_three_port_members_converge_and_a_stopped_one_dies():
    members = [TGossip(name=f"t{i}", **TIMING) for i in range(3)]
    events = []
    members[0].on_event = lambda e, m: events.append((e, m.name))
    stopped = set()
    try:
        for g in members:
            g.start()
        assert members[1].join(members[0].addr)
        assert members[2].join(members[0].addr)
        _wait(lambda: all(_alive(g) == {"t0", "t1", "t2"} for g in members),
              "three alive members on every member")
        members[2].stop()  # a crash: no leave broadcast
        stopped.add(2)
        _wait(lambda: ("dead", "t2") in events, "t2 declared dead")
        statuses = [e for e, name in events if name == "t2"]
        assert "suspect" in statuses and statuses.index("suspect") < statuses.index("dead")
        _wait(lambda: "t2" not in members[0].members, "t2 reaped", timeout=45.0)
        assert _alive(members[1]) == {"t0", "t1"}
    finally:
        for i, g in enumerate(members):
            if i not in stopped:
                g.stop()


# ---------------------------------------------------------------------------
# (c) the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encrypted", [False, True])
def test_a_port_member_and_a_jax_member_see_each_other(encrypted):
    key = jkeyring.generate_key() if encrypted else ""
    t = TGossip(name="port-0", encrypt_key=key, tags={"pkg": "torch"}, **TIMING)
    j = JGossip(name="jax-0", encrypt_key=key, tags={"pkg": "jax"}, **TIMING)
    outsiders = [TGossip(name="port-x", encrypt_key=tkeyring.generate_key(), **TIMING),
                 JGossip(name="jax-x", encrypt_key=jkeyring.generate_key(), **TIMING)]
    started = []
    try:
        for g in (t, j, *(outsiders if encrypted else ())):
            g.start()
            started.append(g)
        assert t.join(j.addr)
        _wait(lambda: _alive(t) == _alive(j) == {"port-0", "jax-0"},
              "the port member and the JAX member alive on both")
        with j._lock:
            assert j.members["port-0"].tags == {"pkg": "torch"}
        with t._lock:
            assert t.members["jax-0"].tags == {"pkg": "jax"}
        if encrypted:
            # a member under another key never merges, from either package
            assert not outsiders[0].join(j.addr, timeout=1.0)
            assert not outsiders[1].join(t.addr, timeout=1.0)
            assert _alive(t) == _alive(j) == {"port-0", "jax-0"}
        # the JAX member leaves; the port member sees it go
        j.leave()
        _wait(lambda: "jax-0" not in _alive(t), "the JAX member's leave seen by the port")
    finally:
        for g in started:
            g.stop()
