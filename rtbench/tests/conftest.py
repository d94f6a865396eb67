"""Shared set-up of the benchmark's own tests (run from the repository's
root: ``python -m pytest rtbench/tests -q``)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the cells at a size the CPU holds: the program's plain kernels run there
SMALL_SCENE = {"kind": "terrain", "triangles": 2000, "extent": 100.0, "height": 8.0,
               "pairs": True, "material": {"diffuse": [0.55, 0.5, 0.45],
                                           "ambient": [0.55, 0.5, 0.45]},
               "light": [0.0, 200.0, 0.0]}


def small(workload: str) -> dict:
    """Overrides that cut a cell to 2,000 triangles, a 32-pixel-wide image,
    two bounces and a short cycle."""
    return {"config": {"scene": SMALL_SCENE, "width": 32,
                       "height": 24 if "sah-wide" in workload else 32, "bounces": 2},
            "traffic": {"period": 6 if "refit" in workload else 4, "capture_span": 2,
                        "captures": 2, "profile_steps": 2}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
