"""CPU helpers of mcbench's tests: a cell cut to a size a test run holds,
run through the harness with the kernels' plain twins standing in for the
card (the twins draw the kernels' Philox stream and run their tape)."""

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mcbench import harness, spec  # noqa: E402

BLOCK = 1 << 18
STREAM_SIZE = 3 * BLOCK + 12345  # a partial last block
ONESHOT_SIZE = 300_000
SEED = 2**31 + 17


def small_cell(name):
    cell = spec.Cell(name)
    if cell.streamed:
        cell.traffic["size"] = STREAM_SIZE
        cell.traffic["options"]["block_size"] = BLOCK
    else:
        cell.traffic["size"] = ONESHOT_SIZE
    return cell


@pytest.fixture
def twins(monkeypatch):
    """The timed path on the CPU: the kernels' wrappers run their plain
    twins there, and the streamed driver is told to take the kernel path."""
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import cuda_exec, streaming

    previous = config.device()
    monkeypatch.setattr(cuda_exec, "environment_issue", lambda device=None: None)
    monkeypatch.setattr(streaming, "_resolve_executor", lambda *args: "cuda")
    yield
    config.set_device(previous)


def run_small(name, seconds=0.0, seed=SEED):
    """One CPU run of the cut-down cell: (result, earlier lines, checks)."""
    cell = small_cell(name)
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                            check_launches=False)


@pytest.fixture
def cuda_card():
    """The card, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from probabilit_tpu_torch import config

    previous = config.device()
    config.set_device("cuda")
    yield
    config.set_device(previous)
