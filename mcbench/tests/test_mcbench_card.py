"""Each cell's run on the card, with a short window, is correct."""

import time

import pytest

from mcbench import harness, spec

CELLS = ["dag20.stream.moments", "corr50.stream.moments", "dag20.stream.tails", "corr50.oneshot"]


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_card")
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    result, _, _ = harness.run_cell(spec.Cell(name), 2**31 + 5, 1.0, False, time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["failed"] == 0
