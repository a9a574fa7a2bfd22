"""Shared fixtures of the benchmark's own tests, all on the CPU:
``python -m pytest benchmark/tests -q`` from the repository's root.  A cell
is cut to a size a test can hold: 12 layers, 16 bins x 4 Gauss points,
two planets."""

import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(name: str, members: int = 2, **helios):
    """The manifest's cell ``name`` at the tests' size."""
    from benchmark.core import cell as cell_mod
    c = cell_mod.load(name)
    c.config["helios"].update(nlayer=12, **helios)
    c.config["table"].update(nbin=16, ny=4)
    c.traffic["members"] = c.traffic["members"][:members]
    c.traffic["batch"] = min(c.traffic["batch"], members)
    return c


def run_tiny(c, seed: int = 2 ** 31 + 7):
    """One run of the tiny cell ``c`` on the CPU, its window one round."""
    from benchmark import run
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmpdir:
        return run.run_cell(c, seed, 0.0, False, "cpu",
                            time.perf_counter(), tmpdir)


@pytest.fixture(scope="session")
def tiny_runs():
    """One CPU run of each tiny cell, shared by the tests that read it."""
    return {name: run_tiny(tiny(name)) for name in
            ("flagship.single", "flagship_matrix.single", "flagship.grid8")}
