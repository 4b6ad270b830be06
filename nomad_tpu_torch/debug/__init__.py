"""Operator debug plane (the ``nomad operator debug`` + pprof-handlers
role): continuous profiling, flight recorder, watchdog, debug bundles.

Five parts, layered:

- :mod:`.profiler` — pure-stdlib sampling wall-clock profiler
  (``sys._current_frames`` at ~100Hz, thread-name classified, folded
  flame-graph stacks, blocked-site attribution, ``applier_block_frac``);
- :mod:`.flight`   — bounded ring of periodic process snapshots (the
  pre-incident tape) + the ONE shared process sampler;
- :mod:`.watchdog` — cheap rules over the recorder; trips counted and
  (with a ``bundle_dir``) auto-captured;
- :mod:`.devprof`  — the device plane: compile ledger + HLO collective
  census, h2d/d2h transfer accounting, and the collective-round
  counter distilled to ``collective_rounds_per_placement`` (ROADMAP
  item 2's instrument; ``operator device`` CLI + ``tpu_devprof`` in
  /v1/metrics);
- :mod:`.bundle`   — the artifact: profiles + flight dump + slowest
  traces + metrics + redacted config + device plane + findings, dir or
  tarball.

Surfaces: ``/debug/pprof/profile?seconds=N`` and ``/v1/debug/bundle``
(both ``enable_debug``-gated, agent:read), ``nomad-tpu operator
debug``, ``scripts/debug.sh``, and the ``debug{}`` agent config stanza
(flight_interval / flight_retain / watchdog rule overrides /
bundle_dir). See OBSERVABILITY.md for the operator walkthrough.
"""

from .bundle import capture_bundle, make_tarball, redact_config  # noqa: F401
from .flight import FlightRecorder, rss_mb, sample_process  # noqa: F401
from .profiler import (  # noqa: F401
    SamplingProfiler,
    classify_thread,
    profile,
    render_folded,
    thread_dump,
)
from .watchdog import Watchdog  # noqa: F401
