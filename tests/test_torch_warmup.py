"""The port's warm-up against the JAX package's, on the CPU.

The ladder's shapes go through one bucketing policy in both packages, and
a prewarm of the same shapes and stanzas warms as many programs: the JAX
package compiles each, the port launches each plain version once (the
kernels on the card, in tests/test_torch_gpu.py). A ``Server`` with the
``prewarm_kernels`` stanza starts its warm-up thread and stops cleanly.
"""

import logging
import threading
import time

import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.state import planes as state_planes
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu.tpu import warmup as jwarmup
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.core import broker as tbroker
from nomad_tpu_torch.debug import devprof as tdevprof
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import warmup as twarmup
from nomad_tpu_torch.tpu import wavefront as twf

#: seconds a stopped server's threads get to end (the node drainer polls
#: every 2 s)
STOP_S = 10.0


@pytest.fixture(autouse=True)
def _stanzas_reset():
    tile_rows = state_planes.TILE_ROWS
    for m in (jwf, twf, jpaging, tpaging):
        m.reset()
    yield
    for m in (jwf, twf, jpaging, tpaging):
        m.reset()
    state_planes.TILE_ROWS = tile_rows


@pytest.mark.parametrize("n_nodes", [1, 100, 1000, 4096, 10000, 65536])
def test_bucket_shape_matches_jax(n_nodes):
    for n_allocs in (1, 100, 1000, 50000):
        assert twarmup.bucket_shape(n_nodes, n_allocs) == jwarmup.bucket_shape(n_nodes, n_allocs)


def test_default_ladder_matches_jax():
    assert twarmup.DEFAULT_SIZES == jwarmup.DEFAULT_SIZES
    assert twarmup.DEFAULT_SHAPES == jwarmup.DEFAULT_SHAPES
    assert twarmup.DEFAULT_V == jwarmup.DEFAULT_V


def _stanzas_on():
    for m in (jwf, twf):
        m.configure(enabled=True)
    for m in (jpaging, tpaging):
        m.configure(enabled=True, tile_nodes=1024)


def test_prewarm_warms_as_many_programs_as_jax():
    _stanzas_on()
    shapes = ((128, 128),)
    want = jwarmup.prewarm(shapes)
    assert want == 6  # runs, windowed, exact, wavefront, tile count, tile window
    tdevprof.reset()
    assert twarmup.prewarm(shapes, device="cpu") == want
    # each of them entered the launch ledger (unless an earlier test in this
    # process launched it first) and moved no counter
    planners = {e["planner"] for e in tdevprof.snapshot()["compile_ledger"]}
    assert planners <= {"runs", "windowed", "exact", "wavefront", "paged"}
    assert tdevprof.totals()["rounds"] == 0 and tdevprof.totals()["h2d_bytes"] == 0


def test_prewarm_drain_warms_as_many_programs_as_jax():
    _stanzas_on()
    want = jwarmup.prewarm_drain(128, 4)
    assert want == 5  # the fused scan, the wavefront, the bases, two verify buckets
    assert twarmup.prewarm_drain(128, 4, device="cpu") == want
    for m in (jwf, twf):
        m.configure(enabled=False)
    assert twarmup.prewarm_drain(128, 4, device="cpu") == jwarmup.prewarm_drain(128, 4) == 4


def test_failed_prewarm_logs_and_falls_short(monkeypatch, caplog):
    def refuse(*args, **kwargs):
        raise tk.KernelFault("refused for the test")

    monkeypatch.setattr(tk, "plan_batch_windowed", refuse)
    with caplog.at_level(logging.WARNING, logger="nomad_tpu.tpu.warmup"):
        # the runs planner warms, then the windowed one fails its shape
        assert twarmup.prewarm(((128, 128), (256, 128)), device="cpu") == 2
    failures = [r for r in caplog.records if "prewarm of the planners" in r.getMessage()]
    assert len(failures) == 2 and all(r.exc_info for r in failures)


def test_server_prewarms_and_stops_cleanly():
    from nomad_tpu_torch.core.server import Server

    before = set(threading.enumerate())
    server = Server({"seed": 3, "prewarm_kernels": True, "batch_drain": 4,
                     "prewarm_drain_nodes": 100}, device="cpu")
    try:
        server.start(num_workers=1)
        thread = server._prewarm_thread
        assert thread.name == "tpu-prewarm"
        thread.join(timeout=60)
        assert not thread.is_alive()
        # every program of the default ladder and the drain ladder warmed:
        # three planners a shape, the fused scan, the bases and the
        # verify's two row buckets
        assert thread.warmed == 3 * len(twarmup.DEFAULT_SHAPES) + 4
        # and each has launched in this process (the set of launched keys
        # outlives the ledger's reset by an earlier test)
        keys = [("exact", "E8G8A16N128"), ("verify_rows", "N128R8"), ("verify_rows", "N128R64")]
        for n_pad, a_pad in twarmup.DEFAULT_SHAPES:
            keys += [("runs", f"N{n_pad}A{a_pad}"), ("windowed", f"N{n_pad}A{a_pad}"),
                     ("exact", f"E1G1A{a_pad}N{n_pad}")]
        assert not [k for k in keys if (*k, "plain") not in tdevprof._LAUNCHED]
    finally:
        server.stop()
    wheel = tbroker.shared_timer_wheel()._thread
    deadline = time.monotonic() + STOP_S
    left = []
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t not in before and t is not wheel and t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    assert not left, [t.name for t in left]
