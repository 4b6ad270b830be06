#!/usr/bin/env python3
"""Run another checkout's chip_smoke.py with this checkout's device time
(``chip_smoke.device_us``), so that an A/B of two trees reads every device
time by one rule.

    python3 nomad_tpu_torch/tools/smoke_tree.py --tree DIR

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` under ``build/``). Its chip_smoke.py runs from
DIR as ``python3 chip_smoke.py`` would there, with its own phases, kernels
and output; only ``device_us`` is this checkout's. Exits with its code.
"""

import argparse
import importlib
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True)
    tree = ap.parse_args().tree.resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    device_us = chip_smoke.device_us
    sys.path[0] = str(tree)
    for name in [m for m in sys.modules if m.split(".")[0] in ("nomad_tpu_torch", "chip_smoke")]:
        del sys.modules[name]
    os.chdir(tree)
    theirs = importlib.import_module("chip_smoke")
    if Path(theirs.__file__).resolve().parent != tree:
        raise SystemExit(f"smoke_tree: chip_smoke came from {theirs.__file__}, not {tree}")
    theirs.device_us = device_us
    return theirs.main()


if __name__ == "__main__":
    sys.exit(main())
