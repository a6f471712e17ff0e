"""Shared pieces of the benchmark's tests: a cell shrunk to a size the CPU
runs in seconds, and the ``card`` marker and fixture (a test that needs a
CUDA card takes the ``card`` fixture, which skips it without one)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run these tests on the card")
    return torch.device("cuda", 0)


def tiny(cell):
    """``cell`` at 120x160 with short clips and small batches."""
    mix = copy.deepcopy(cell.traffic)
    conf = copy.deepcopy(cell.config)
    mix.update(height=120, width=160)
    mix["lengths"].update(low=20, high=70, strata=3)
    if mix["content"]["kind"] == "pool":
        mix["content"]["frames"] = 8
    else:
        mix["content"].update(bases=2, hold=16)
    conf["detector"]["frame_batch"] = 8 * conf["dp"]
    conf["check_frames"] = 90
    return cell._replace(traffic=mix, config=conf)
