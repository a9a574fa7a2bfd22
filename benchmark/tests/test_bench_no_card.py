"""Without a CUDA card, and in a directory that holds only the benchmark,
a run exits with a code other than 0 and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark.core.cell import BENCH_DIR, ROOT


def run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flagship.single",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = run(ROOT)
    assert p.returncode != 0 and p.stdout == "", p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0 and p.stdout == "", p.stderr


def test_unknown_cell_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40])
def test_rounds_are_the_same_work_for_every_seed(seed):
    from benchmark.core import drive
    r = drive.rounds(seed, 8, 1)
    for _ in range(3):
        assert sorted(m for call in next(r) for m in call) == list(range(8))
    a = [next(drive.rounds(seed, 8, 8)) for _ in range(2)]
    assert a[0] == a[1]
