"""The plain reference against the port's plain executor and the kernels'
plain twins on the CPU, and its control against the limits."""

import json

import numpy as np
import pytest
import torch
from conftest import run_small, small_cell

from mcbench import compare, harness, reference, spec

START = 3 * (1 << 24) + 5  # a start past the first blocks, not a multiple of 4
N = 1 << 16


@pytest.fixture(autouse=True)
def on_the_cpu():
    from probabilit_tpu_torch import config

    previous = config.device()
    config.set_device("cpu")
    yield
    config.set_device(previous)


def config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


def test_uniforms_are_the_kernels_stream():
    from probabilit_tpu_torch.engine import cuda_exec

    seed = 2**40 + 2**33 + 12345
    ours = reference.uniforms(reference.seed_words(seed), START, N, range(10), "cpu")
    theirs = cuda_exec.philox_uniforms(cuda_exec.seed_words(seed), N, 10, start=START)
    assert torch.equal(ours, theirs)


def test_uncorrelated_values_match_the_plain_executor():
    cfg = config("mixed_dag_20")
    graph = reference.Graph(cfg)
    u = reference.uniforms(reference.seed_words(7), START, N, range(graph.d), "cpu")
    ref = graph.values(u, reference.Arithmetic())
    port = spec.build_graph(cfg).sample_from_quantiles(u).double()
    assert (port - ref).abs().max() <= 1e-5 * ref.std()


def test_correlated_values_match_the_kernel_twin():
    from probabilit_tpu_torch.engine import compile as plan_of
    from probabilit_tpu_torch.engine import cuda_exec

    cfg = config("mixed_correlated_50")
    graph = reference.Graph(cfg)
    sink = spec.build_graph(cfg)
    plan = plan_of.get_plan(sink)
    np.testing.assert_allclose(graph.P @ graph.P.T, plan.corr_matrix, atol=1e-8)
    words = cuda_exec.seed_words(11)
    tape = cuda_exec.lowered(plan, [sink._id], "cpu")
    ab = cuda_exec.recolor_transform(plan, words, N, device="cpu", start=START)
    twin, _ = cuda_exec.run(tape, words, N, ab, start=START)
    ref = graph.block(reference.seed_words(11), START, N, N, "cpu", reference.Arithmetic())
    assert (twin[0].double() - ref).abs().max() <= 1e-4 * ref.std()


@pytest.mark.usefixtures("twins")
@pytest.mark.parametrize("name", ["dag20.stream.moments", "corr50.stream.moments",
                                  "dag20.stream.tails", "corr50.oneshot"])
def test_the_timed_path_on_its_twins_is_correct(name):
    result, _, _ = run_small(name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["dag20.stream.moments", "corr50.stream.moments",
                                  "dag20.stream.tails", "corr50.oneshot"])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_control_is_not_correct(name, seed):
    """The reference in bfloat16, in the program's place, fails the cell's
    limits."""
    cell = small_cell(name)
    s = spec.call_seed(seed, 0, 0)
    ref = harness.reference_answer(cell, s, "cpu")
    low = harness.reference_answer(cell, s, "cpu", arith="bfloat16")
    ok, rows = compare.judge(harness.numbers(cell, low, ref), cell.limits)
    assert not ok, rows
