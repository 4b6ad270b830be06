"""Phase 8 of ``chip_smoke.py``, the agent in a fresh process, rehearsed
on the CPU at a small size (``AGENT_SMALL``).

The phase starts ``python -m nomad_tpu_torch agent -device cpu``, waits
for the warm-up's count over ``/v1/metrics``, registers the nodes over
RPC, runs the jobs over the CLI and HTTP, checks them and stops the
agent with SIGTERM. A warm-up launch that fails in the agent is logged
and shortens the count, and that alone must fail the phase: the second
test makes one launch of the child's warm-up raise (a ``sitecustomize``
on the child's ``PYTHONPATH`` replaces the usage bases' wrapper before
the agent starts). The phase stops its child in ``finally`` either way.
"""

import importlib.util
import os
import textwrap

import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_agent_phase_passes_on_the_cpu(chip_smoke):
    size = chip_smoke.AGENT_SMALL
    out = chip_smoke.agent_phase("cpu", size)
    _, want = chip_smoke.agent_ladder(size["nodes"], chip_smoke.AGENT_DRAIN)
    timings = out["timings"]
    assert timings["warmed"] == want == 13
    # the jobs' fused exact batches: each the bucket of its lanes
    assert timings["exact_batches"]


def test_a_failed_warm_up_launch_fails_the_agent_phase(chip_smoke, tmp_path, monkeypatch):
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {ROOT!r})
        from nomad_tpu_torch.tpu import drain


        def refuse(*args, **kwargs):
            raise RuntimeError("usage bases refused for the test")


        drain.used_bases = refuse
        """))
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, [str(tmp_path), path])))
    with pytest.raises(SystemExit) as failed:
        chip_smoke.agent_phase("cpu", chip_smoke.AGENT_SMALL)
    msg = str(failed.value)
    assert "the warm-up launched 12 programs, not the ladder's 13" in msg
    # the agent's own warning, with its exception, read from its monitor
    assert "prewarm of the drain batch" in msg and "usage bases refused for the test" in msg
