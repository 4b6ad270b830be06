"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, for ``sm_90a`` with ``--fmad=false`` and without fast math (the
float contract in ``nomad_tpu_torch/tpu/__init__.py``); the objects link into
one shared library with a plain C interface. The library lands in
``build/nomad_tpu_torch/<hash>/`` at the repository root, keyed by a hash of
the sources and flags, and is built at first use only. Its build or load
enters the device ledger (``debug/devprof.py``) once, with its seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "nomad_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

# C entry points: (pointer arguments, int arguments); every one ends with
# the CUDA stream and returns the launch status
_ENTRY_POINTS = {
    "ntt_exact_scan": (26, 6),
    "ntt_runs": (22, 5),
    "ntt_runs_scratch": (1, 3),
    "ntt_windowed": (13, 4),
    "ntt_windowed_scratch": (1, 3),
    "ntt_windowed_shape": (1, 3),
    "ntt_used_bases": (5, 5),
    "ntt_scatter_rows": (4, 3),
    "ntt_verify_rows": (5, 3),
    "ntt_verify_shape": (1, 3),
    "ntt_wavefront": (29, 8),
    "ntt_wavefront_shape": (1, 4),
    "ntt_tile_count": (6, 5),
    "ntt_tile_window": (16, 11),
    "ntt_binpack": (3, 1),
    "ntt_class_boosts": (8, 1),
    "ntt_scores": (16, 3),
    "ntt_rot_incl": (2, 2),
    "ntt_mesh_shape": (2, 7),
    "ntt_mesh_exact": (1, 8),
    "ntt_mesh_runs": (1, 7),
    "ntt_mesh_windowed": (1, 6),
    "ntt_mesh_verify": (1, 4),
    "ntt_mesh_bases": (1, 6),
    "ntt_mesh_scatter": (1, 4),
    "ntt_mesh_wavefront": (1, 10),
    "ntt_mesh_tile_count": (4, 6),
    "ntt_mesh_tile_window": (11, 12),
}

_LIB = None
_LIB_LOCK = threading.Lock()
#: ``ptxas`` resource lines (registers, shared memory, spills) of a build,
#: kept beside its library
PTXAS_LOG = "ptxas.log"


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return found


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources lives (built or not)."""
    units = sorted(CSRC.glob("*.cu"))
    return BUILD_ROOT / _source_hash(units + sorted(CSRC.glob("*.cuh"))) / "libnomad_tpu_torch.so"


def build() -> Path:
    """Compile (when the sources changed) and return the library's path."""
    units = sorted(CSRC.glob("*.cu"))
    lib = library_path()
    out_dir = lib.parent
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    tag = f"{os.getpid()}"
    jobs = []
    for src in units:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    ptxas, failed = [], []
    for src, _, proc in jobs:
        log, _ = proc.communicate()
        ptxas += [f"{src.name}: {ln}" for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    (out_dir / PTXAS_LOG).write_text("".join(f"{ln}\n" for ln in ptxas))
    tmp = out_dir / f"libnomad_tpu_torch.{tag}.so"
    link = subprocess.run(
        [compiler, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use (one thread builds
    it; the others wait)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ..debug import devprof

            t0 = time.perf_counter()
            built = not library_path().exists()
            path = build()
            lib = ctypes.CDLL(str(path))
            for name, (n_ptr, n_int) in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.ntt_error_string.argtypes = [ctypes.c_int]
            lib.ntt_error_string.restype = ctypes.c_char_p
            # one ledger entry keyed by the sources' hash
            devprof.record_compile("library", path.parent.name, False,
                                   "build" if built else "load", time.perf_counter() - t0)
            _LIB = lib
    return _LIB
