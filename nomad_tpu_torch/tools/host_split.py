#!/usr/bin/env python3
"""Host microseconds of the server path's two one-shot calls, in a process
of their own, at chip_smoke.py's shapes: the usage bases (K9,
``drain.used_bases``: E 32, N 10,240, A 4,096, C 4) and the dense verify
(K8, ``kernel.verify_rows``: R 4,096 over N 10,240). Each call is timed
whole and by part (the check, the output's allocation, the stream query,
the ctypes call with the launch it enqueues), two turns before a
torch.profiler session and two after it, since chip_smoke.py times its
wrappers in a process that has traced many times.

    python3 nomad_tpu_torch/tools/host_split.py [--tree DIR]

``--tree DIR`` times another checkout's wrappers instead (for example the
parent commit, unpacked with ``git archive`` under ``build/``): the whole
calls only, as its parts may differ. Prints the card line and one JSON
line; every number is the median of 200 calls after a warm-up, with no
synchronize inside the timed calls.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
CALLS = 200


def host_us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def calls(own: bool) -> dict:
    """name -> a call with no arguments, on seeded inputs on the card."""
    from nomad_tpu_torch.tpu import _build, drain, kernel

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    E, N, C, A = 32, 10_240, 4, 4096

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    used0 = put(rng.integers(0, 5000, (N, C)))
    placements = put(rng.integers(-1, N, A))
    demands = put(rng.integers(0, 900, (A, C)))
    eval_of = put(np.sort(rng.integers(0, E, A)))
    capacity = used0 + put(rng.integers(0, 2000, (N, C)))
    rows = put(np.concatenate([rng.integers(0, N, 1057), np.zeros(A - 1057)]))
    deltas = put(np.concatenate([rng.integers(-300, 300, (1057, C)), np.zeros((A - 1057, C))]))
    bases_args = (used0, placements, demands, eval_of)
    verify_args = (capacity, used0, rows, deltas)
    out = dict(
        used_bases=lambda: drain.used_bases(*bases_args, E, N),
        verify_rows=lambda: kernel.verify_rows(*verify_args),
    )
    if not own:
        return out
    lib = _build.library()
    stream = kernel._stream_ptr(dev)
    base_out = used0.new_empty((E, N, C))
    fits = rows.new_empty(A, dtype=torch.bool)
    out.update(
        used_bases_check=lambda: drain._bases_dims(*bases_args),
        used_bases_alloc=lambda: used0.new_empty((E, N, C)),
        verify_rows_check=lambda: kernel._verify_dims(*verify_args),
        verify_rows_alloc=lambda: rows.new_empty(A, dtype=torch.bool),
        stream=lambda: kernel._stream_ptr(dev),
        used_bases_ctypes_call=lambda: lib.ntt_used_bases(
            used0.data_ptr(), placements.data_ptr(), demands.data_ptr(), eval_of.data_ptr(),
            base_out.data_ptr(), N, C, A, E, N, stream),
        verify_rows_ctypes_call=lambda: lib.ntt_verify_rows(
            capacity.data_ptr(), used0.data_ptr(), rows.data_ptr(), deltas.data_ptr(),
            fits.data_ptr(), N, C, A, stream),
    )
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("host_split: no CUDA device", file=sys.stderr)
        return 2
    tree = (args.tree or ROOT).resolve()
    sys.path.insert(0, str(tree))
    import nomad_tpu_torch

    if Path(nomad_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"host_split: nomad_tpu_torch came from {nomad_tpu_torch.__file__}")
    from torch.profiler import ProfilerActivity, profile, schedule

    fns = calls(own=args.tree is None)
    turns = []
    for turn in range(4):
        if turn == 2:  # trace the two wrappers as chip_smoke.py's device_us does
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                for _ in range(2):
                    for _ in range(20):
                        fns["used_bases"]()
                        fns["verify_rows"]()
                    prof.step()
            torch.cuda.synchronize()
        turns.append({name: host_us(fn) for name, fn in fns.items()})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no output")
    print(json.dumps(dict(tree=str(tree), calls=CALLS, before_profiler=turns[:2],
                          after_profiler=turns[2:])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
