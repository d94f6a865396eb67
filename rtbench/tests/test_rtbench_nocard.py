"""Without a card a run exits non-zero and prints no result; a checkout
that holds only the benchmark does the same."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                           "terrain1m-split.orbit", "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return False
        except ValueError:
            pass
    return True


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run(REPO)
    assert p.returncode != 0
    assert _no_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(REPO / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".tmp"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert _no_result(p.stdout)
