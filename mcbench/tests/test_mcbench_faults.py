"""A run with the timed path broken underneath is not correct.

Each test drives a whole run on the CPU (the kernels' plain twins stand in
for the card) with one fault planted in the program: a fold step that
leaves its state unchanged, half of each block left out with the mean
taken over the rest, a stale answer, or an answer altered where it is
produced.  The cells run on one card, so no exchange between cards can
be left out."""

import pytest
from conftest import run_small

from mcbench import spec

STREAMS = ["dag20.stream.moments", "corr50.stream.moments", "dag20.stream.tails"]

pytestmark = pytest.mark.usefixtures("twins")


@pytest.mark.parametrize("name", STREAMS)
def test_a_fold_step_that_leaves_its_state_unchanged(name, monkeypatch):
    from probabilit_tpu_torch.engine import streaming

    merge, seen = streaming._merge, []

    def stuck(carry, block, where_mode, moments):
        seen.append(1)
        return carry if len(seen) % 4 == 2 else merge(carry, block, where_mode, moments)

    monkeypatch.setattr(streaming, "_merge", stuck)
    result, _, _ = run_small(name)
    assert seen and not result["correct"], result["checks"]


@pytest.mark.parametrize("name", STREAMS)
def test_half_of_each_block_left_out(name, monkeypatch):
    from probabilit_tpu_torch.engine import streaming

    moments = streaming._block_moments

    def half(x, y, cnt, where_mode, m, covariance=False):
        return moments(x, y, cnt // 2, where_mode, m, covariance)

    monkeypatch.setattr(streaming, "_block_moments", half)
    result, _, _ = run_small(name)
    assert not result["correct"], result["checks"]


def _altering_run(monkeypatch, alter):
    from probabilit_tpu_torch.engine import cuda_exec

    run, calls = cuda_exec.run, []

    def altered(tape, words, n, ab=None, start=0):
        out, flag = run(tape, words, n, ab, start)
        calls.append(1)
        if len(calls) % 3 == 2:
            out = alter(out.clone())
        return out, flag

    monkeypatch.setattr(cuda_exec, "run", altered)


def _one_sample_altered(out):
    out[0, 12345] = 2.0 * out[0].abs().max()
    return out


@pytest.mark.parametrize("name", [*STREAMS, "corr50.oneshot"])
def test_one_sample_altered_where_it_is_produced(name, monkeypatch):
    _altering_run(monkeypatch, _one_sample_altered)
    result, _, _ = run_small(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", [*STREAMS, "corr50.oneshot"])
def test_a_call_that_returns_its_previous_answer(name, monkeypatch):
    from probabilit_tpu_torch.models.graph import Node

    entry = spec.Cell(name).traffic["entry"]
    call, answers = getattr(Node, entry), []

    def stale(self, *args, **kwargs):
        answers.append(call(self, *args, **kwargs))
        return answers[max(len(answers) - 2, 0)]  # the previous call's

    monkeypatch.setattr(Node, entry, stale)
    result, _, _ = run_small(name)
    assert len(answers) >= 2 and not result["correct"], result["checks"]


def test_a_launch_that_returns_its_previous_output(monkeypatch):
    from probabilit_tpu_torch.engine import cuda_exec

    run, last = cuda_exec.run, []

    def stale(tape, words, n, ab=None, start=0):
        if last:
            return last[0]
        last.append(run(tape, words, n, ab, start))
        return last[0]

    monkeypatch.setattr(cuda_exec, "run", stale)
    result, _, _ = run_small("corr50.oneshot")
    assert not result["correct"], result["checks"]


def test_half_of_the_samples_left_out(monkeypatch):
    def alter(out):
        half = out.shape[1] // 2
        out[:, half : 2 * half] = out[:, :half]
        return out

    _altering_run(monkeypatch, alter)
    result, _, _ = run_small("corr50.oneshot")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", [*STREAMS, "corr50.oneshot"])
def test_an_unbroken_run_is_correct(name):
    result, _, _ = run_small(name)
    assert result["correct"] and isinstance(result["checks"], dict)
