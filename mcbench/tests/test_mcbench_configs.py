"""Each configuration file builds the graph that
``probabilit_tpu_torch.models.benchmarks`` builds."""

import json

import numpy as np
import pytest
import torch

from mcbench import reference, spec

BUILDERS = {"mixed_dag_20": "mixed_dag_20", "mixed_correlated_50": "mixed_correlated_50"}


@pytest.fixture(autouse=True)
def on_the_cpu():
    from probabilit_tpu_torch import config

    previous = config.device()
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_config_builds_the_benchmark_graph(name):
    from probabilit_tpu_torch.engine import compile as plan_of
    from probabilit_tpu_torch.models import benchmarks

    config = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    ours = plan_of.get_plan(spec.build_graph(config))
    theirs = plan_of.get_plan(getattr(benchmarks, BUILDERS[name])())
    assert ours.d == theirs.d
    assert [n.distr for n in ours.dist_nodes] == [n.distr for n in theirs.dist_nodes]
    assert len(ours.topo) == len(theirs.topo)
    if theirs.corr_matrix is None:
        assert ours.corr_matrix is None
    else:
        np.testing.assert_array_equal(ours.corr_matrix, theirs.corr_matrix)
    u = reference.uniforms(reference.seed_words(99), 7, 4096, range(ours.d), "cpu")
    a = ours.sink.sample_from_quantiles(u)
    b = theirs.sink.sample_from_quantiles(u)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_reference_columns_are_the_programs(name):
    """The reference gives the c-th distribution of the file column c, as
    the program's plan does."""
    from probabilit_tpu_torch.engine import compile as plan_of

    config = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    nodes = {}
    plan = plan_of.get_plan(spec.build_graph(config, nodes))
    graph = reference.Graph(config)
    assert {n: plan.col_of[nodes[n]._id] for n in graph.col} == graph.col
    assert [v._id for v in plan.corr_vars] == [nodes[n]._id for n in graph.corr_vars]
