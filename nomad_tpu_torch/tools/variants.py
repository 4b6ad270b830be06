"""Build one kernel source of ``nomad_tpu_torch/tpu/csrc/`` as committed
and as variants, each alone, for the ``*_variants.py`` tools.

A variant is the committed source with a list of exact text replacements,
each of whose text must be in the source once. Each copy compiles alone
(nvcc with the library's flags, every copy at once) into its own shared
library under ``out/<name>/``, beside the headers and, where ``errors`` is
set, ``exact_scan.cu``, which holds the library's error strings.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

from nomad_tpu_torch.tpu import _build


def build(tool: str, source: str, variants: dict, entry_points, out: Path,
          errors: bool = True) -> dict:
    """name -> loaded library of ``source`` as committed (``committed``)
    and of each variant (name -> [(committed text, replacement)]), with
    ``entry_points`` typed as ``_build`` types them."""
    committed = (_build.CSRC / source).read_text()
    stem = Path(source).stem
    jobs = {}
    for name, swaps in {"committed": [], **variants}.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        text = committed
        for old, new in swaps:
            if text.count(old) != 1:
                raise SystemExit(f"{tool}: {name}: its text is not in {source} once")
            text = text.replace(old, new)
        (d / source).write_text(text)
        sources = [d / source]
        if errors and source != "exact_scan.cu":
            shutil.copy(_build.CSRC / "exact_scan.cu", d)
            sources.append(d / "exact_scan.cu")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / f"{stem}.so"),
               *map(str, sources)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tool}: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out / name / f"{stem}.so"))
        for entry in entry_points:
            n_ptr, n_int = _build._ENTRY_POINTS[entry]
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        if errors:
            lib.ntt_error_string.argtypes = [ctypes.c_int]
            lib.ntt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs
