"""On the card, at the cells' own sizes: a short window of each
closed-loop cell on one card comes out correct, and the control (the
reference with float8 operands in the program's place) fails the same
limits.  Skips without a card; run on the card with
``python3 -m pytest benchmark/tests/test_bench_card.py``."""

import os
import time

import pytest

from benchmark import check, closed_loop, spec


@pytest.mark.card
@pytest.mark.parametrize("name", ["single_1080p_i420", "multiface_1080p_k4"])
def test_cell_correct_and_control_not(card, name):
    cell = spec.load(name)
    out = closed_loop.run(cell, 2**31 + 101, 5.0, False, time.perf_counter(), os.devnull,
                          control=True)
    assert check.judge(out.numbers, out.limits), out.numbers
    assert not check.judge(out.control, out.limits), out.control
