"""sii_nonlife12: its file builds the register it states, the reference's
Poisson ppf is scipy's, the reference agrees with the port's plain
executor and K1's twin, and its cell's check tells a right answer from
the bfloat16 control and from a stale answer."""

import importlib.util
import json

import numpy as np
import pytest
import scipy.stats
import torch
from conftest import run_small, small_cell

from mcbench import compare, harness, reference, spec

NAME = "sii_nonlife12"
CELL = "table_risk_corr.stream.moments"
START = 3 * (1 << 24) + 5  # a start past the first blocks, not a multiple of 4
N = 1 << 16
# The program rounds a count's quantile to float32 twice over (its ndtr of
# a float32 recoloured score, its float32 CDF table): one ulp of 1 is
# 6e-8, and a quantile within that of a CDF step may take the next count.
# NEAR holds that with room; at most NEAR_SHARE_MAX of the samples lie
# within NEAR of a step (measured 7.6e-5 to 2.9e-4 a count at seed 11).
NEAR = 1e-6
NEAR_SHARE_MAX = 2e-3
SINK_TOL = 1e-4  # of the reference's std: the float32 recolouring and division


@pytest.fixture(autouse=True)
def on_the_cpu():
    from probabilit_tpu_torch import config

    previous = config.device()
    config.set_device("cpu")
    yield
    config.set_device(previous)


def config():
    return json.loads((spec.HERE / "configs" / f"{NAME}.json").read_text())


def ppfs_module():
    path = spec.HERE / "configs" / f"{NAME}.py"
    module_spec = importlib.util.spec_from_file_location(f"mcbench_test_{NAME}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


COUNTS = [node for node in config()["nodes"] if "family" in node]
MUS = sorted({node["params"]["mu"] for node in COUNTS})


def test_the_file_builds_the_register_it_states():
    """Twelve Poisson claim counts, correlated in the file's order by a
    target the repair keeps (it is positive definite); the reference
    reads the plan's columns."""
    from probabilit_tpu_torch.engine import compile as plan_of

    cfg, nodes = config(), {}
    plan = plan_of.get_plan(spec.build_graph(cfg, nodes))
    target = np.asarray(cfg["correlation"]["matrix"])
    assert plan.d == len(COUNTS) == 12 and {n.distr for n in plan.dist_nodes} == {"poisson"}
    assert np.linalg.eigvalsh(target).min() > 0.1
    np.testing.assert_allclose(plan.corr_matrix, target, atol=1e-12)
    graph = reference.Graph(cfg)
    assert {n: plan.col_of[nodes[n]._id] for n in graph.col} == graph.col
    assert [v._id for v in plan.corr_vars] == [nodes[n]._id for n in graph.corr_vars]
    assert graph.corr_vars == cfg["correlation"]["variables"]


@pytest.mark.parametrize("mu", MUS)
def test_the_reference_ppf_is_scipys(mu):
    """At and beside every float32 CDF step a quantile of the kernel's
    range can reach, and at seeded quantiles."""
    law = scipy.stats.poisson(mu)
    lo, hi = 2.0**-24, 1.0 - 2.0**-24
    k = np.arange(law.ppf(lo) - 1, law.ppf(hi) + 2)
    steps = law.cdf(k).astype(np.float32)
    q = np.concatenate([steps, np.nextafter(steps, np.float32(0)), np.nextafter(steps, np.float32(1)),
                        np.random.default_rng(5).uniform(lo, hi, 4096).astype(np.float32)])
    q = q[(q >= np.float32(lo)) & (q <= np.float32(hi))].astype(np.float64)
    got = ppfs_module().PPFS["poisson"]({"mu": mu}, torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), law.ppf(q))


def _reference_drivers(graph, module, seed):
    """The reference's sink, and each count's value and the distance of its
    quantile from the nearest CDF step, at rows START .. START + N - 1."""
    arith = reference.Arithmetic()
    u = reference.uniforms(reference.seed_words(seed), START, N, range(graph.d), "cpu")
    z = graph._scores(u[:, graph.corr_columns()], arith)
    ab = graph._solve(reference._score_sums(z), N)
    y = z @ ab[0].T + ab[1]
    counts = {}
    for node in COUNTS:
        q = arith.unit(torch.special.ndtr(y[:, graph.corr_vars.index(node["name"])]))
        x = graph._ppf(node, q)
        cdf = module.table(node["params"]["mu"], "cpu")
        k = x.long()
        below = torch.where(k > 0, cdf[(k - 1).clamp(min=0)], torch.zeros_like(q))
        counts[node["name"]] = (x, torch.minimum(q - below, cdf[k] - q))
    return graph.values(u, arith, ab), counts


def test_the_reference_agrees_with_the_plain_executor_and_the_twin():
    from probabilit_tpu_torch.engine import compile as plan_of
    from probabilit_tpu_torch.engine import cuda_exec

    cfg, nodes, seed = config(), {}, 11
    graph = reference.Graph(cfg)
    sink = spec.build_graph(cfg, nodes)
    plan = plan_of.get_plan(sink)
    np.testing.assert_allclose(graph.P @ graph.P.T, plan.corr_matrix, atol=1e-8)
    keep = {nodes[node["name"]]._id for node in COUNTS} | {sink._id}
    order = cuda_exec.keep_order(plan, keep)
    words = cuda_exec.seed_words(seed)
    ab = cuda_exec.recolor_transform(plan, words, N, device="cpu", start=START)
    twin, flag = cuda_exec.run(cuda_exec.lowered(plan, order, "cpu"), words, N, ab, start=START)
    assert int(flag) == 0
    U = cuda_exec.philox_uniforms(words, N, plan.d, start=START)
    plain = plan_of.build_body(plan, keep, generated=True)(U)
    ref, counts = _reference_drivers(graph, ppfs_module(), seed)
    agree = torch.ones(N, dtype=torch.bool)
    for name, (x, distance) in counts.items():
        near = distance < NEAR
        assert near.double().mean() <= NEAR_SHARE_MAX, name
        nid = nodes[name]._id
        for got in (twin[order.index(nid)].double(), plain[nid].double()):
            off = got != x
            # Off only next to a step, and then by the one count across it.
            assert not (off & ~near).any() and (got - x).abs().max() <= 1, name
            agree &= ~off
    std = ref.std()
    for got in (twin[order.index(sink._id)].double(), plain[sink._id].double()):
        assert (got - ref).abs()[agree].max() <= SINK_TOL * std


@pytest.mark.usefixtures("twins")
@pytest.mark.parametrize("seed", [2**31 + 17, 2**40 + 3, 7])
def test_the_timed_path_on_its_twins_is_correct(seed):
    result, _, _ = run_small(CELL, seed=seed)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_control_is_not_correct(seed):
    """The reference in bfloat16, in the program's place, fails the cell's
    limits."""
    cell = small_cell(CELL)
    s = spec.call_seed(seed, 0, 0)
    ref = harness.reference_answer(cell, s, "cpu")
    low = harness.reference_answer(cell, s, "cpu", arith="bfloat16")
    ok, rows = compare.judge(harness.numbers(cell, low, ref), cell.limits)
    assert not ok, rows


@pytest.mark.usefixtures("twins")
def test_a_call_that_returns_its_previous_answer(monkeypatch):
    from probabilit_tpu_torch.models.graph import Node

    call, answers = Node.estimate, []

    def stale(self, *args, **kwargs):
        answers.append(call(self, *args, **kwargs))
        return answers[max(len(answers) - 2, 0)]  # the previous call's

    monkeypatch.setattr(Node, "estimate", stale)
    result, _, _ = run_small(CELL)
    assert len(answers) >= 2 and not result["correct"], result["checks"]
