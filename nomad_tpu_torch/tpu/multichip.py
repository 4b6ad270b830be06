"""The mesh's dry run and the scored multichip bench.

The port's copy of ``nomad_tpu/tpu/multichip.py`` (with
``__graft_entry__.dryrun_multichip``'s dry run):

- :func:`dryrun_multichip` splits the exact scan's node axis over
  ``n_shards`` shards (``tpu/shard.py``'s ``batch_specs``) and plans one
  full batch of 512 placements over 1,024 nodes through the sharded kernel
  (``csrc/mesh.cu``; its sharded plain version on the CPU), checked
  placement for placement against the unsharded scan on the same inputs;
- :func:`bench_multichip` runs the four planners (exact scan, runs,
  windowed, wavefront) unsharded and over the mesh on the same inputs,
  times each arm after an untimed warm pass, pins sharded == unsharded
  placements value for value and reports the JAX module's keys;
- :func:`write_artifact` writes the report with a noise-filtered, capped
  stderr tail, by default as ``build/nomad_tpu_torch/multichip/
  MULTICHIP_rNN.json`` (never the repository root's series of the JAX
  package's runs);
- ``python -m nomad_tpu_torch.tpu.multichip --devices 4 --device cuda
  --no-artifact`` is the command line.

What differs from the JAX module, at the device seams only: the mesh is
the port's (``shard.configure(n, device=...)`` builds the one-card
stand-in; without ``device`` it counts cards, and the bench skips when
there are too few); the port's kernels have one flavor, so the parity pin
compares the timed pair itself and ``parity_mode`` always reads
``deterministic``; ``recompiles`` counts the kernel library's builds
after the first (a hand-written kernel compiles once, with the library).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from . import kernel, shard

#: default bench scale: the node axis crosses every shard (8 shards x 256
#: rows); MULTICHIP_NODES/ALLOCS/DEVICES scale it, as the JAX module's do
DEFAULT_NODES = int(os.environ.get("MULTICHIP_NODES", "2048"))
DEFAULT_ALLOCS = int(os.environ.get("MULTICHIP_ALLOCS", "512"))
DEFAULT_DEVICES = int(os.environ.get("MULTICHIP_DEVICES", "8"))

#: stderr lines matching any of these are known environment noise, not
#: signal. The patterns are the JAX module's (XLA's CPU AOT loader
#: warnings and absl's pre-init banner), kept so that a tail filters as
#: the JAX artifacts' did; the port runs no XLA, so its own stderr
#: passes through whole. Kept specific: an unknown error line must never
#: be filtered into silence.
NOISE_PATTERNS = (
    r"cpu_aot_loader",
    r"Loading XLA:CPU AOT result",
    r"machine features?: \[",
    r"This could lead to execution errors such as SIGILL",
    r"WARNING: All log messages before absl::InitializeLog",
    r"external/org_tensorflow",
)

#: hard cap on the artifact's tail field (chars, after the filter)
TAIL_CAP = 2000

_NOISE_RE = re.compile("|".join(NOISE_PATTERNS))

#: where the artifacts go by default: under the build directory that
#: .gitignore lists
ARTIFACT_DIR = Path(__file__).resolve().parents[2] / "build" / "nomad_tpu_torch" / "multichip"


def filter_noise_tail(text: str, cap: int = TAIL_CAP) -> str:
    """Drop known-noise stderr lines and cap the result to its LAST
    ``cap`` characters (the tail end is where a real failure prints)."""
    kept = [ln for ln in text.splitlines() if ln and not _NOISE_RE.search(ln)]
    out = "\n".join(kept)
    if len(out) > cap:
        out = out[-cap:]
        # never start mid-line after the cut
        nl = out.find("\n")
        if 0 <= nl < len(out) - 1:
            out = out[nl + 1:]
    return out


@contextlib.contextmanager
def capture_stderr_fd():
    """Capture fd-2 writes (native code bypasses sys.stderr) into a temp
    file; yields a callable returning what was captured so far."""
    import tempfile

    saved = os.dup(2)
    tmp = tempfile.TemporaryFile(mode="w+b")
    os.dup2(tmp.fileno(), 2)
    try:
        def read() -> str:
            os.fsync(2)
            tmp.seek(0)
            return tmp.read().decode("utf-8", "replace")

        yield read
    finally:
        os.dup2(saved, 2)
        os.close(saved)
        tmp.close()


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def example_batch(n_nodes: int = 1024, n_allocs: int = 512, n_groups: int = 1,
                  n_values: int = 4):
    """The dry run's (BatchArgs, BatchState) as numpy arrays: seeded nodes
    of three resource columns, one group spread over ``n_values`` values
    by target, every node feasible (``__graft_entry__._example_batch``)."""
    rng = np.random.default_rng(0)
    capacity = np.stack(
        [
            rng.integers(2000, 8000, n_nodes),
            rng.integers(4096, 16384, n_nodes),
            np.full(n_nodes, 100 * 1024),
        ],
        axis=1,
    ).astype(np.int32)
    reserved = np.tile(np.array([100, 256, 4096], dtype=np.int32), (n_nodes, 1))
    usable = (capacity[:, :2] - reserved[:, :2]).astype(np.float32)

    args = kernel.BatchArgs(
        capacity=capacity,
        usable=usable,
        feasible=np.ones((n_groups, n_nodes), dtype=bool),
        affinity=np.zeros((n_groups, n_nodes), dtype=np.float32),
        affinity_present=np.zeros((n_groups, n_nodes), dtype=bool),
        group_count=np.full(n_groups, n_allocs, dtype=np.int32),
        group_eval=np.zeros(n_groups, dtype=np.int32),
        node_value=np.tile(np.arange(n_nodes, dtype=np.int32) % n_values, (n_groups, 1)),
        spread_desired=np.full((n_groups, n_values), float(n_allocs) / n_values,
                               dtype=np.float32),
        spread_implicit=np.full(n_groups, -1.0, dtype=np.float32),
        spread_weight_frac=np.ones(n_groups, dtype=np.float32),
        spread_even=np.zeros(n_groups, dtype=bool),
        spread_active=np.ones(n_groups, dtype=bool),
        perm=rng.permutation(n_nodes).astype(np.int32)[None, :],
        ring=np.array([n_nodes], dtype=np.int32),
        demands=np.tile(np.array([100, 128, 10], dtype=np.int32), (n_allocs, 1)),
        groups=np.zeros(n_allocs, dtype=np.int32),
        limits=np.full(n_allocs, n_nodes, dtype=np.int32),
        valid=np.ones(n_allocs, dtype=bool),
    )
    init = kernel.BatchState(
        used=reserved.copy(),
        collisions=np.zeros((n_groups, n_nodes), dtype=np.int32),
        spread_counts=np.zeros((n_groups, n_values), dtype=np.int32),
        spread_present=np.zeros((n_groups, n_values), dtype=bool),
        offset=np.zeros(1, dtype=np.int32),
    )
    return args, init


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Split the exact scan's node axis over ``n_shards`` shards on
    ``device`` (CUDA unless the caller asks for the CPU) and run one full
    batch of 512 allocs over 1,024 nodes (rounded up to a multiple of the
    shards); every alloc must place, on the nodes the unsharded scan picks.
    Returns the run's sizes, counts and placements (numpy); raises
    ``AssertionError`` when the placements diverge."""
    dev = resolve_device(device)
    n_allocs = 512
    n_nodes = max(1024, n_shards)
    if n_nodes % n_shards:
        n_nodes = ((n_nodes // n_shards) + 1) * n_shards
    args, init = example_batch(n_nodes=n_nodes, n_allocs=n_allocs)
    mesh = shard.Mesh(n_shards, dev)
    aspec, sspec = shard.batch_specs()
    _, got = kernel.plan_batch(shard.put(args, aspec, mesh), shard.put(init, sspec, mesh),
                               n_nodes)
    got = got.cpu().numpy()
    placed = int((got >= 0).sum())
    assert placed == n_allocs, f"expected {n_allocs} placements, got {placed}"
    _, want = kernel.plan_batch(kernel.from_numpy(args, dev), kernel.from_numpy(init, dev),
                                n_nodes)
    mismatches = int((want.cpu().numpy() != got).sum())
    assert mismatches == 0, (
        f"sharded placements diverge from unsharded at {mismatches}/{n_allocs} positions"
    )
    return dict(shards=n_shards, nodes=n_nodes, allocs=n_allocs, placed=placed,
                mismatches=mismatches, placements=got)


# ---------------------------------------------------------------------------
# the scored bench
# ---------------------------------------------------------------------------


def _time_best(fn, samples: int = 2) -> float:
    best = None
    for _ in range(samples):
        t0 = time.monotonic()
        fn()
        dt = time.monotonic() - t0
        best = dt if best is None or dt < best else best
    return best


def _library_builds() -> int:
    """The kernel library's builds and loads in this process (the device
    ledger's ``library`` entries)."""
    from ..debug import devprof

    return sum(e["compiles"] for e in devprof.snapshot()["compile_ledger"]
               if e["planner"] == "library")


def bench_multichip(
    n_devices: int = DEFAULT_DEVICES,
    n_nodes: int = DEFAULT_NODES,
    n_allocs: int = DEFAULT_ALLOCS,
    seed: int = 0,
    samples: int = 2,
    device=None,
) -> dict:
    """Run the four planners unsharded and over a mesh of ``n_devices``
    shards on the same inputs; returns the scored report (no I/O:
    :func:`write_artifact` persists it). With ``device`` the mesh is the
    one-card stand-in on that device; without it the visible cards are
    counted and too few skip the bench. The process mesh is off again when
    the bench returns."""
    from ..debug import devprof
    from . import problems
    from . import wavefront as _wavefront

    try:
        mesh = shard.configure(n_devices, device=device)
        if mesh is None:
            return {
                "n_devices": n_devices,
                "nodes": n_nodes,
                "allocs": n_allocs,
                "ok": False,
                "skipped": True,
                "reason": f"need {n_devices} devices",
            }
        dev = mesh.device
        # pad to the mesh-divisible node bucket so ANY scale shards (uneven
        # real counts leave the padding on the last shard)
        c = problems.pad_cluster(
            problems.build_cluster(n_nodes, n_allocs, seed=seed),
            shard.node_bucket(n_nodes, mesh),
        )
        A = n_allocs
        planners: dict[str, dict] = {}

        def host(x):
            return x.cpu().numpy()

        def score(name, run_plain, run_sharded):
            # warm arms, then timed best-of-N with the rebuild pin
            want = host(run_plain())
            got_warm = host(run_sharded())
            t_plain = _time_best(lambda: host(run_plain()), samples)
            builds0 = _library_builds()
            # the sharded arm's collective rounds a dispatch, from the
            # device ledger's round counter around the timed arm
            rounds0 = devprof.rounds_snapshot().get(name, {})
            t_shard = _time_best(lambda: host(run_sharded()), samples)
            devprof.totals()  # folds the rounds the card has finished
            rounds1 = devprof.rounds_snapshot().get(name, {})
            builds1 = _library_builds()

            def _delta(key):
                return rounds1.get(key, 0) - rounds0.get(key, 0)

            s_disp = _delta("sharded_dispatches")
            s_rounds = _delta("sharded_rounds")
            s_place = _delta("sharded_placements")
            census = {}
            for e in devprof.snapshot()["compile_ledger"]:
                if e["planner"] == name and e["sharded"] and e["collectives"]:
                    census = e["collectives"]
                    break
            got = host(run_sharded())
            placed = int((want >= 0).sum())
            # one flavor of kernels: the timed pair is the parity pair
            matched = int((want == got).sum())
            planners[name] = {
                "unsharded_s": round(t_plain, 4),
                "sharded_s": round(t_shard, 4),
                "speedup": round(t_plain / t_shard, 3) if t_shard else None,
                "placed": placed,
                "parity": round(matched / max(len(want), 1), 6),
                "parity_checked": int(len(want)),
                "parity_mode": "deterministic",
                "fast_pair_agreement": round(matched / max(len(want), 1), 6),
                "recompiles": builds1 - builds0,
                "warm_equal": bool(np.array_equal(want, got_warm)),
                "mesh_comm_frac": devprof.mesh_comm_frac(t_plain, t_shard),
                "collective_rounds": round(s_rounds / s_disp) if s_disp else None,
                "collective_rounds_per_placement": (
                    round(s_rounds / s_place, 4) if s_place else None
                ),
                "collective_census": census,
            }

        n_real = c.get("n_real", n_nodes)

        # exact sequential scan
        bargs, binit = problems.exact_problem(c)
        bargs, binit = kernel.BatchArgs(**bargs), kernel.BatchState(**binit)
        baspec, bsspec = shard.batch_specs()
        b_plain = kernel.from_numpy((bargs, binit), dev)
        b_shard = (shard.put(bargs, baspec, mesh), shard.put(binit, bsspec, mesh))
        score(
            "exact",
            lambda: kernel.plan_batch(*b_plain, n_real)[1],
            lambda: kernel.plan_batch(*b_shard, n_real)[1],
        )

        # run-based full-ring planner (the spread/affinity headline path)
        rargs, rinit = problems.runs_problem(c)
        rargs, rinit = kernel.RunArgs(**rargs), tuple(rinit)
        raspec, rispec = shard.run_specs()
        r_plain = kernel.from_numpy((rargs, rinit), dev)
        r_shard = (shard.put(rargs, raspec, mesh), shard.put(rinit, rispec, mesh))
        score(
            "runs",
            lambda: kernel.plan_batch_runs(*r_plain, A, False)[0],
            lambda: kernel.plan_batch_runs(*r_shard, A, False)[0],
        )

        # rotation-parallel windowed planner
        wargs, wused0, wcoll0 = problems.window_problem(c)
        wargs = kernel.WindowArgs(**wargs)
        waspec, (wuspec, wcspec) = shard.window_specs()
        w_plain = kernel.from_numpy((wargs, wused0, wcoll0), dev)
        w_shard = (shard.put(wargs, waspec, mesh), shard.put(wused0, wuspec, mesh),
                   shard.put(wcoll0, wcspec, mesh))
        score(
            "windowed",
            lambda: kernel.plan_batch_windowed(*w_plain, n_real, A)[0],
            lambda: kernel.plan_batch_windowed(*w_shard, n_real, A)[0],
        )

        # the wavefront's conflict-free batched commits: the sequential scan
        # on the SAME (args, init) is the oracle, so the parity pin proves
        # the sharded wavefront reproduces the sequential placements, while
        # its crpp column counts a collective round per wavefront round.
        # MULTICHIP_WAVEFRONT=0 skips the section.
        if os.environ.get("MULTICHIP_WAVEFRONT", "1") not in ("0", ""):
            fargs, finit = problems.wavefront_problem(c)
            fargs, finit = kernel.BatchArgs(**fargs), kernel.BatchState(**finit)
            faspec, fsspec = shard.wavefront_specs()
            f_plain = kernel.from_numpy((fargs, finit), dev)
            f_shard = (shard.put(fargs, faspec, mesh), shard.put(finit, fsspec, mesh))
            n_shards = shard.mesh_size(mesh)
            score(
                "wavefront",
                lambda: kernel.plan_batch(*f_plain, n_real)[1],
                lambda: _wavefront.plan_batch_wavefront(*f_shard, n_real, n_shards=n_shards)[1],
            )
            # sharded sequential against sharded wavefront on the same args
            t_seq_sharded = _time_best(
                lambda: host(kernel.plan_batch(*f_shard, n_real)[1]), samples)
            wf = planners["wavefront"]
            wf["sequential_sharded_s"] = round(t_seq_sharded, 4)
            wf["wavefront_speedup"] = (
                round(t_seq_sharded / wf["sharded_s"], 3) if wf["sharded_s"] else None
            )
    finally:
        shard.configure(enabled=False)

    # the contract: parity 1.0 with real placements in every planner
    ok = all(p["parity"] == 1.0 and p["placed"] > 0 for p in planners.values())
    t_plain_total = sum(p["unsharded_s"] for p in planners.values())
    t_shard_total = sum(p["sharded_s"] for p in planners.values())
    return {
        "n_devices": n_devices,
        "nodes": n_nodes,
        "allocs": n_allocs,
        "seed": seed,
        "samples": samples,
        "device": str(dev),
        "planners": planners,
        "mesh_comm_frac": devprof.mesh_comm_frac(t_plain_total, t_shard_total),
        "collective_rounds": sum(p["collective_rounds"] or 0 for p in planners.values()),
        "devprof": devprof.summary(),
        "ok": ok,
        "skipped": False,
    }


def next_artifact_path(root: str = None) -> str:
    """The next free ``MULTICHIP_rNN.json`` round slot under ``root``
    (``ARTIFACT_DIR`` by default)."""
    root = str(ARTIFACT_DIR) if root is None else root
    taken = []
    for p in glob.glob(os.path.join(root, "MULTICHIP_r*.json")):
        m = re.search(r"MULTICHIP_r(\d+)\.json$", p)
        if m:
            taken.append(int(m.group(1)))
    nn = max(taken, default=0) + 1
    return os.path.join(root, f"MULTICHIP_r{nn:02d}.json")


def write_artifact(report: dict, tail: str = "", path: str = None) -> str:
    """Persist the scored report with a noise-filtered, capped tail."""
    path = path or next_artifact_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    report = dict(report)
    report["tail"] = filter_noise_tail(tail)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    return path


def summary_line(report: dict) -> str:
    """One greppable line (the report's headline must survive a truncated
    log tail)."""
    if report.get("skipped"):
        return f"MULTICHIP_SUMMARY skipped=1 reason={report.get('reason')}"
    parts = [
        f"devices={report['n_devices']}",
        f"nodes={report['nodes']}",
        f"allocs={report['allocs']}",
        f"ok={int(report['ok'])}",
    ]
    if "mesh_comm_frac" in report:
        parts.append(f"mesh_comm_frac={report['mesh_comm_frac']}")
        parts.append(f"collective_rounds={report['collective_rounds']}")
    for name, p in report.get("planners", {}).items():
        line = (
            f"{name}={p['sharded_s']}s/x{p['speedup']}"
            f"/parity{p['parity']}/rc{p['recompiles']}"
        )
        if p.get("collective_rounds_per_placement") is not None:
            line += f"/crpp{p['collective_rounds_per_placement']}"
        if p.get("wavefront_speedup") is not None:
            line += f"/wfx{p['wavefront_speedup']}"
        parts.append(line)
    return "MULTICHIP_SUMMARY " + " ".join(parts)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="scored multichip bench (writes MULTICHIP_rNN.json under "
                    "build/nomad_tpu_torch/multichip/)"
    )
    ap.add_argument("--devices", type=int, default=DEFAULT_DEVICES)
    ap.add_argument("--nodes", type=int, default=DEFAULT_NODES)
    ap.add_argument("--allocs", type=int, default=DEFAULT_ALLOCS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="shards on this one device (cuda, cpu); default: one a card")
    ap.add_argument("--out", default=None, help="artifact path override")
    ap.add_argument("--no-artifact", action="store_true", help="print the report, write nothing")
    args = ap.parse_args(argv)

    with capture_stderr_fd() as read_tail:
        report = bench_multichip(
            n_devices=args.devices, n_nodes=args.nodes, n_allocs=args.allocs, seed=args.seed,
            device=args.device,
        )
        tail = read_tail()
    if not args.no_artifact:
        path = write_artifact(report, tail=tail, path=args.out)
        print(f"wrote {path}")
    else:
        print(json.dumps(report, indent=1, default=str))
    print(summary_line(report))
    return 0 if report.get("ok") or report.get("skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
