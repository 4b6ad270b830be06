"""Import hygiene of the port: it never loads JAX or the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_for_tests import torch

from nomad_tpu_torch import resolve_device
from nomad_tpu_torch.tpu import planner, problems

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nomad_tpu_torch")
MODULES = [
    "nomad_tpu_torch",
    "nomad_tpu_torch.tpu",
    "nomad_tpu_torch.tpu.problems",
    "nomad_tpu_torch.tpu.exact_np",
    "nomad_tpu_torch.tpu.kernel",
    "nomad_tpu_torch.tpu.planner",
    "nomad_tpu_torch.tpu._build",
]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "nomad_tpu")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port loaded {out.stdout.strip()}"


def _python_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_import_in_the_port_sources():
    found = []
    for path in _python_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            found += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not found


def test_entry_points_default_to_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.zeros(1)) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA-less refusal is not observable")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    c = problems.build_cluster(16, 4)
    planes = problems.eval_planes(*problems.exact_problem(c))
    with pytest.raises(RuntimeError, match="CUDA"):
        planner.plan_eval(planes)
    placements, stats = planner.plan_eval(planes, device="cpu")
    assert stats["mode"] == "exact-scan" and (placements >= 0).all()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
