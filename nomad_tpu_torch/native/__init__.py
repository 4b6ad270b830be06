"""Native helpers: the C batch-materialization module ``_fastobj.c``,
compiled on demand with the system C compiler and cached next to the
source (or in NOMAD_TPU_NATIVE_DIR when the package directory is
read-only). A host extension, not a device kernel: without a compiler
its callers take their pure-Python loops."""

from __future__ import annotations

import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def _build_dir() -> str:
    d = os.environ.get("NOMAD_TPU_NATIVE_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
        return d
    return _HERE


_FASTOBJ = None
_FASTOBJ_TRIED = False


def fastobj():
    """The C batch-materialization module (_fastobj.c), compiled on demand;
    returns None when no toolchain is available so callers
    fall back to the pure-Python loops (same semantics, ~5x slower at
    50K-alloc plan scale)."""
    global _FASTOBJ, _FASTOBJ_TRIED
    if _FASTOBJ_TRIED:
        return _FASTOBJ
    with _BUILD_LOCK:
        if _FASTOBJ_TRIED:
            return _FASTOBJ
        try:
            _FASTOBJ = _build_fastobj()
        except Exception as e:
            import logging

            logging.getLogger(__name__).warning(
                "C fast-path (_fastobj) unavailable, using the pure-Python "
                "loops (~5x slower at 50K-alloc plan scale): %s", e
            )
            _FASTOBJ = None
        _FASTOBJ_TRIED = True
    return _FASTOBJ


def _build_fastobj():
    import importlib.machinery
    import importlib.util
    import sysconfig

    import sys

    src = os.path.join(_HERE, "_fastobj.c")
    # cache tag in the filename: a stale .so built against another
    # interpreter ABI must never be dlopen'd (mtime alone can't tell)
    out = os.path.join(
        _build_dir(), f"_fastobj.{sys.implementation.cache_tag}.so"
    )
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        cc = (
            shutil.which("cc")
            or shutil.which("gcc")
            or shutil.which("clang")
        )
        if cc is None:
            raise NativeBuildError("no C compiler on PATH")
        inc = sysconfig.get_paths()["include"]
        # per-process tmp name: _BUILD_LOCK is per-process, so two fresh
        # processes may build concurrently — each must os.replace its own
        # fully-written file (the rename is atomic; last writer wins)
        tmp = f"{out}.tmp.{os.getpid()}.so"
        proc = subprocess.run(
            [cc, "-O2", "-shared", "-fPIC", f"-I{inc}", "-o", tmp, src],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise NativeBuildError(f"_fastobj build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    loader = importlib.machinery.ExtensionFileLoader("_fastobj", out)
    spec = importlib.util.spec_from_file_location("_fastobj", out, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod
