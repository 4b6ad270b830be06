#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (nomad_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card: its name and power limit from nvidia-smi;
2. build: nvcc compiles the port's kernels (nomad_tpu_torch/tpu/csrc) for
   sm_90a, one process per source, and prints ptxas's resource lines;
3. kernel vs plain version on the card at mid sizes: the exact scan, the
   run planner and the windowed planner must give the same placements,
   final state and round counts as their plain PyTorch versions;
4. the main path at full width: ``planner.plan_eval`` on a 10K-node eval
   of 50K allocs spread over 4 values (run planner), a 10K x 50K eval with
   limit 10 (windowed planner) and a 10K-node eval of 8 groups (exact
   scan), with every launch counter set to 0 before and read after; then
   output checks (no node over capacity), timings, parity of the run and
   windowed planners against the exact-scan kernel on the same planes, the
   exact scan against the float64 host oracle on a small eval, and each
   kernel against its plain version at the main-path shape;
5. one JSON line of per-kernel numbers, the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Without a CUDA card it exits with status 2 and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations to score one node: two bit-stable 10^x (about 32
# each), the two free fractions, binpack, anti-affinity, the plane count,
# sum and mean
SCORE_OPS = 95
# integer operations of one fit check: an add and a compare per column
FIT_OPS_PER_COL = 2

NODES, ALLOCS, VALUES = 10_000, 50_000, 4
EXACT_GROUPS, EXACT_ALLOCS = 8, 8_192
LIMIT = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples: int = 3) -> tuple:
    """(median ms per call by CUDA events after one warm-up call, result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def host_ms(fn) -> tuple:
    """(ms of one call ending in a synchronize, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def nbytes(*trees) -> int:
    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
    return total


def scan_ops(positions: int, scored: int, cols: int) -> int:
    """Operations of fit-checking ``positions`` nodes and scoring ``scored``."""
    return positions * cols * FIT_OPS_PER_COL + scored * SCORE_OPS


def bound(bytes_moved: int, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        got = torch.as_tensor(got).cpu().to(torch.int64)
        want = torch.as_tensor(want).cpu().to(torch.int64)
        if got.shape != want.shape:
            fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        if got.numel():
            err = max(err, int((got - want).abs().max()))
    return err


def check_capacity(planes: dict, placements: np.ndarray, what: str) -> int:
    """No node over capacity after the placements; returns the count placed."""
    n_real = planes["n_real"]
    if placements.dtype != np.int32 or placements.shape != (planes["a_real"],):
        fail(f"{what}: placements {placements.dtype}{placements.shape}")
    placed = placements >= 0
    if (placements[placed] >= n_real).any():
        fail(f"{what}: placement on a node outside the ring")
    used = planes["used0"].astype(np.int64).copy()
    groups = planes["groups"][: planes["a_real"]]
    np.add.at(used, placements[placed], planes["demands"][: planes["a_real"]][placed])
    if (used > planes["capacity"]).any():
        fail(f"{what}: a node is over capacity")
    for g in np.unique(groups[placed]):
        if not planes["feasible"][g][placements[placed & (groups == g)]].all():
            fail(f"{what}: placement on an infeasible node")
    return int(placed.sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    from nomad_tpu_torch.tpu import _build, exact_np, kernel, planner, problems

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path} in {time.perf_counter() - t0:.1f}s")
    for line in (lib_path.parent / _build.PTXAS_LOG).read_text().splitlines():
        log(f"  {line}")

    errs = {"exact_scan": 0, "runs": 0, "windowed": 0}  # kernel vs plain, max abs

    # ---- 3. kernel vs plain version on the card, mid sizes ----------------
    mid = problems.pad_cluster(problems.build_cluster(2000, 1024, seed=11), 2048)
    for label, (args, init) in (
        ("exact G=1", problems.exact_problem(mid)),
        ("exact G=8", problems.wavefront_problem(mid, n_groups=8)),
    ):
        a, s = kernel.from_numpy(args, dev), kernel.from_numpy(init, dev)
        got_state, got = kernel.plan_batch(a, s, 2000)
        torch.cuda.synchronize()
        want_state, want = kernel.plan_batch_ref(a, s, 2000)
        err = max_abs_err([(got, want), *zip(got_state, want_state)])
        if err:
            fail(f"{label}: kernel differs from the plain version (max abs err {err})")
        errs["exact_scan"] = max(errs["exact_scan"], err)
        log(f"mid {label}: N=2048 A=1024 identical, placed {int((got >= 0).sum())}")
    mid = problems.pad_cluster(problems.build_cluster(4000, 8192, seed=12), 4096)
    rargs, rinit = kernel.from_numpy(problems.runs_problem(mid), dev)
    got, got_rounds = kernel.plan_batch_runs(rargs, rinit, 8192)
    torch.cuda.synchronize()
    want, want_rounds = kernel.plan_batch_runs_ref(rargs, rinit, 8192)
    err = max_abs_err([(got, want)]) + abs(int(got_rounds) - want_rounds)
    if err:
        fail(f"runs: kernel differs from the plain version ({err}; rounds "
             f"{int(got_rounds)} vs {want_rounds})")
    log(f"mid runs: N=4096 A=8192 identical, rounds {want_rounds}")
    wargs, wused, wcoll = problems.window_problem(mid, limit=LIMIT)
    wa, wu, wc = kernel.from_numpy(wargs, dev), *kernel.from_numpy((wused, wcoll), dev)
    got, got_rounds = kernel.plan_batch_windowed(wa, wu, wc, 4000, 8192)
    torch.cuda.synchronize()
    want, want_rounds = kernel.plan_batch_windowed_ref(wa, wu, wc, 4000, 8192)
    err = max_abs_err([(got, want)]) + abs(int(got_rounds) - want_rounds)
    if err:
        fail(f"windowed: kernel differs from the plain version ({err})")
    log(f"mid windowed: N=4096 A=8192 L={LIMIT} identical, rounds {want_rounds}")

    # ---- 4. the main path at full width ------------------------------------
    cluster = problems.build_cluster(NODES, ALLOCS, n_values=VALUES, seed=0)
    spread = problems.eval_planes(*problems.exact_problem(cluster, spread=True))
    windowed = problems.eval_planes(*problems.exact_problem(cluster, spread=False))
    windowed["limits"] = np.full_like(windowed["limits"], LIMIT)
    tenants = problems.eval_planes(*problems.wavefront_problem(
        problems.build_cluster(NODES, EXACT_ALLOCS, n_values=VALUES, seed=1),
        n_groups=EXACT_GROUPS))
    evals = {"runs": spread, "windowed": windowed, "exact-scan": tenants}

    kernel.reset_launches()
    results = {mode: planner.plan_eval(planes, dev) for mode, planes in evals.items()}
    launches = dict(kernel.LAUNCHES)
    log(f"main path launches: {launches}")
    for mode, (_, stats) in results.items():
        if stats["mode"] != mode:
            fail(f"eval planned in mode {stats['mode']}, expected {mode}")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    for mode, (placements, stats) in results.items():
        placed = check_capacity(evals[mode], placements, mode)
        log(f"main {mode}: {evals[mode]['a_real']} allocs x {evals[mode]['n_real']} nodes, "
            f"placed {placed}, rounds {stats['rounds']}, kernel {stats['kernel_s'] * 1e3:.2f} ms")

    # timings of the headline eval through the entry point
    samples = []
    planner.plan_eval(spread, dev)  # warm-up
    for _ in range(3):
        t = time.perf_counter()
        _, stats = planner.plan_eval(spread, dev)
        samples.append(((time.perf_counter() - t) * 1e3, stats["kernel_s"] * 1e3))
    log("headline plan_eval 10K x 50K spread (e2e ms, kernel ms): "
        + ", ".join(f"({e:.2f}, {k:.2f})" for e, k in samples))

    # parity of the fast planners against the exact-scan kernel
    for mode in ("runs", "windowed"):
        p = planner.pad_planes(evals[mode])
        args, state = planner.exact_inputs(p, dev)
        _, exact = kernel.plan_batch(args, state, p["n_real"])
        exact = exact[: p["a_real"]].cpu().numpy()
        parity = float((exact == results[mode][0]).mean())
        log(f"{mode} vs exact-scan kernel: parity {parity:.6f}")
        if parity < 0.99:
            fail(f"{mode} parity {parity} < 0.99")

    # the exact scan against the float64 host oracle on a small eval
    small = problems.build_cluster(1000, 2000, seed=3)
    sargs, sinit = problems.exact_problem(small)
    _, got = kernel.plan_batch(kernel.from_numpy(sargs, dev), kernel.from_numpy(sinit, dev), 1000)
    oracle = exact_np.plan_exact_np(
        sargs["capacity"].astype(np.int64), sargs["usable"].astype(np.float64),
        sargs["feasible"], sargs["affinity"].astype(np.float64), sargs["affinity_present"],
        sargs["group_count"].astype(np.int64), sargs["node_value"].astype(np.int64),
        sargs["spread_desired"].astype(np.float64), sargs["spread_implicit"].astype(np.float64),
        sargs["spread_weight_frac"].astype(np.float64), sargs["spread_even"],
        sargs["spread_active"], sargs["perm"][0].astype(np.int64),
        sargs["demands"].astype(np.int64), sargs["groups"].astype(np.int64),
        sargs["limits"].astype(np.int64), sinit["used"].astype(np.int64),
        sinit["collisions"].astype(np.int64), sinit["spread_counts"].astype(np.int64),
        sinit["spread_present"],
    )
    parity = float((got.cpu().numpy() == oracle).mean())
    log(f"exact-scan kernel vs float64 host oracle (1000 x 2000): parity {parity:.6f}")
    if parity < 0.99:
        fail(f"exact scan vs host oracle parity {parity} < 0.99")

    # each kernel at its main-path shape: time, plain version, bound
    rows = []
    p = planner.pad_planes(spread)
    rargs, rinit = planner.runs_inputs(p, dev)
    A = p["demands"].shape[0]
    ms, (got, rounds) = cuda_ms(lambda: kernel.plan_batch_runs(rargs, rinit, A))
    plain_ms, (want, want_rounds) = host_ms(lambda: kernel.plan_batch_runs_ref(rargs, rinit, A))
    errs["runs"] = max_abs_err([(got, want)]) + abs(int(rounds) - want_rounds)
    N, C = p["capacity"].shape
    rounds = int(rounds)
    rows.append(("runs", "nomad_tpu_torch/tpu/csrc/runs.cu", "nomad_tpu/tpu/kernel.py:716",
                 ms, plain_ms, nbytes(rargs, rinit, got),
                 rounds * scan_ops(N, int(p["feasible"][0].sum()) + kernel.RUNCAP, C), rounds,
                 f"N={N} A={A} V={VALUES}"))

    p = planner.pad_planes(windowed)
    wargs, wused, wcoll = planner.window_inputs(p, dev)
    A, (N, C) = p["demands"].shape[0], p["capacity"].shape
    ms, (got, rounds) = cuda_ms(lambda: kernel.plan_batch_windowed(wargs, wused, wcoll, p["n_real"], A))
    plain_ms, (want, want_rounds) = host_ms(
        lambda: kernel.plan_batch_windowed_ref(wargs, wused, wcoll, p["n_real"], A))
    errs["windowed"] = max_abs_err([(got, want)]) + abs(int(rounds) - want_rounds)
    rounds = int(rounds)
    rows.append(("windowed", "nomad_tpu_torch/tpu/csrc/windowed.cu",
                 "nomad_tpu/tpu/kernel.py:954", ms, plain_ms, nbytes(wargs, wused, wcoll, got),
                 rounds * scan_ops(N, int(p["feasible"][0].sum()), C), rounds,
                 f"N={N} A={A} L={LIMIT}"))

    p = planner.pad_planes(tenants)
    bargs, bstate = planner.exact_inputs(p, dev)
    A, (N, C) = p["demands"].shape[0], p["capacity"].shape
    ms, (got_state, got) = cuda_ms(lambda: kernel.plan_batch(bargs, bstate, p["n_real"]))
    plain_ms, (want_state, want) = host_ms(lambda: kernel.plan_batch_ref(bargs, bstate, p["n_real"]))
    errs["exact_scan"] = max(errs["exact_scan"],
                             max_abs_err([(got, want), *zip(got_state, want_state)]))
    rows.append(("exact_scan", "nomad_tpu_torch/tpu/csrc/exact_scan.cu",
                 "nomad_tpu/tpu/kernel.py:361", ms, plain_ms,
                 nbytes(bargs, bstate, got, got_state),
                 scan_ops(p["a_real"] * p["n_real"],
                          int(p["feasible"][p["groups"][: p["a_real"]]].sum()), C), p["a_real"],
                 f"N={N} A={A} G={EXACT_GROUPS}"))

    for name, err in errs.items():
        if err:
            fail(f"{name}: kernel differs from its plain version at the main-path shape ({err})")

    kernels = []
    for name, source, replaces, ms, plain_ms, moved, ops, rounds, shape in rows:
        bound_ms, bound_by = bound(moved, ops)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None, rounds=rounds, shape=shape,
        ))
        log(f"{name}: {ms:.3f} ms per launch (plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by}), rounds {rounds}, {shape}")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
