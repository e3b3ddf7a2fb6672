"""The port's sampling entry points against the JAX package.

``sample_from_quantiles`` feeds one seeded quantile matrix to both
packages; every node must agree within 1e-4 of the JAX node's largest
magnitude (measured worst: 2.9e-5 on ``mixed_dag_20``, from the float32
rounding differences of the normal quantile's tails).  ``sample`` draws
its own stream in each package, so there the comparison is statistical:
means within 5 standard errors.
"""

import jax
import numpy as np
import pytest
import scipy.special
import torch

from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jg
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks, graph as tg
from probabilit_tpu_torch.models.distributions import Distribution
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

N = 65536
REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _composite():
    a = JaxDistribution("uniform", loc=1.0, scale=2.0)
    b = JaxDistribution("norm", loc=a, scale=a * 0.5)
    c = JaxDistribution("lognorm", s=0.2, scale=b * b + 1)
    return jg.Avg(a, b, c) + JaxDistribution("triang", c=0.3, loc=b, scale=2)


def _compare_from_quantiles(jax_sink, seed):
    mapping = interop.from_reference(jax_sink)
    sink = mapping[jax_sink._id]
    d = tcompile.get_plan(sink).d
    q = np.random.default_rng(seed).random((N, d))
    jax_sink.sample_from_quantiles(q)
    sink.sample_from_quantiles(q)
    worst = 0.0
    for ref_node in jg.topological_sort(jax_sink):
        ref = np.asarray(ref_node.samples_)
        got = mapping[ref_node._id].samples_
        assert got.shape == ref.shape and str(got.dtype) == f"torch.{ref.dtype}"
        if ref.dtype == np.bool_:
            continue
        got = got.numpy().astype(np.float64)
        scale = np.abs(ref).max()
        worst = max(worst, np.abs(got - ref).max() / scale)
    assert worst <= REL_TOL
    return mapping


@pytest.mark.parametrize("build", [jax_benchmarks.mixed_dag_20, _composite])
def test_from_quantiles_matches_jax_per_node(build):
    _compare_from_quantiles(build(), seed=0)


def test_height_model_matches_jax():
    jax_sink = jax_benchmarks.height_model()
    mapping = _compare_from_quantiles(jax_sink, seed=1)
    male, female = (mapping[p._id].samples_ for p in jax_sink.parents)
    ref = np.asarray(jax_sink.samples_)
    got = mapping[jax_sink._id].samples_.numpy()
    # Only pairs closer than the normal quantile's rounding may differ.
    decided = (male - female).abs().numpy() > 1e-3
    np.testing.assert_array_equal(got[decided], ref[decided])
    assert decided.mean() > 0.999


def test_from_quantiles_rejects_wrong_width():
    with pytest.raises(ValueError, match="8 sampling dimensions"):
        benchmarks.mixed_dag_20().sample_from_quantiles(np.full((4, 3), 0.5))


def test_from_quantiles_clamps_endpoints():
    x = Distribution("norm")
    out = x.sample_from_quantiles(np.array([[0.0], [1.0]]))
    assert torch.isfinite(out).all() and out[0] < -5 and out[1] > 5


def test_plain_executor_means_match_jax():
    jax_sink = jax_benchmarks.mixed_dag_20()
    ref = np.asarray(jax_sink.sample(N, random_state=0, gc_strategy=[]), np.float64)
    got = benchmarks.mixed_dag_20().sample(N, random_state=0, gc_strategy=[]).double().numpy()
    se = np.hypot(ref.std(), got.std()) / np.sqrt(N)
    assert abs(ref.mean() - got.mean()) <= 5 * se


def test_plain_executor_is_deterministic_per_seed():
    sink = benchmarks.mixed_dag_20()
    a = sink.sample(1000, random_state=3)
    b = sink.sample(1000, random_state=3)
    c = sink.sample(1000, random_state=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    rs = np.random.default_rng(5)
    d = sink.sample(1000, random_state=rs)
    e = sink.sample(1000, random_state=rs)  # the Generator advanced
    assert not torch.equal(d, e)
    with pytest.raises(TypeError):
        sink.sample(10, random_state="seed")


def test_plain_executor_keeps_what_gc_strategy_asks():
    price = Distribution("lognorm", s=0.25, scale=50.0)
    volume = Distribution("uniform", loc=1, scale=2)
    revenue = price * volume
    sink = revenue - 10
    out = sink.sample(256, random_state=0, gc_strategy=[revenue])
    assert out.shape == (256,) and out.device == config.device()
    assert hasattr(revenue, "samples_") and not hasattr(price, "samples_")
    torch.testing.assert_close(out, revenue.samples_ - 10)
    sink.sample(256, random_state=0)
    assert hasattr(price, "samples_")


def test_non_finite_values_raise_and_leave_no_stale_samples():
    x = Distribution("norm")
    sink = tg.Log(x)
    x.samples_ = "stale"
    with pytest.raises(ValueError, match="non-finite"):
        sink.sample(1000, random_state=0)
    assert not hasattr(x, "samples_") and not hasattr(sink, "samples_")


def test_correlated_graph_raises_not_implemented():
    # Correlated graphs sample now, through the Student-t copula too.
    a, b = JaxDistribution("norm"), JaxDistribution("norm")
    jax_sink = (a + b).correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
    sink = interop.from_reference(jax_sink)[jax_sink._id]
    assert tcompile.get_plan(sink).corr_vars
    assert sink.sample(100, random_state=0).shape == (100,)
    assert sink.sample(100, random_state=0, correlator="tcopula").shape == (100,)
    q = np.random.default_rng(0).random((20, 2))
    t = sink.sample_from_quantiles(q, correlator="tcopula")
    assert t.shape == (20,) and bool(torch.isfinite(t).all())


def test_cuda_executor_raises_here_and_never_runs_the_plain_version(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(cuda_exec, "run_reference", forbidden)
    monkeypatch.setattr(cuda_exec, "run_tape", forbidden)
    launches = cuda_exec.LAUNCHES
    sink = benchmarks.mixed_dag_20()
    reason = cuda_exec.environment_issue()
    assert reason is not None
    with pytest.raises(ValueError) as err:
        sink.sample(1000, random_state=0, gc_strategy=[], executor="cuda")
    assert str(err.value) == reason
    assert cuda_exec.LAUNCHES == launches


def test_executor_arguments_are_checked():
    sink = benchmarks.mixed_dag_20()
    with pytest.raises(ValueError, match="executor='cuda'"):
        sink.sample(10, gc_strategy=[], executor="pallas")
    with pytest.raises(ValueError, match="gc_strategy"):
        sink.sample(10, executor="cuda")  # keep-everything is refused
    with pytest.raises(ValueError, match="Unknown executor"):
        sink.sample(10, executor="xla")
    # QMC is ported: method= runs on the plain executor, and the kernel
    # refuses it (test_cuda_refusal_states_its_limits).
    out = sink.sample(10, method="sobol")
    assert out.shape == (10,) and bool(torch.isfinite(out).all())


def test_cuda_refusal_states_its_limits():
    """executor='cuda' refuses method= with a message that states what the
    kernel takes now (int32 and bool values included) and what it does not."""
    sink = benchmarks.mixed_dag_20()
    with pytest.raises(ValueError) as err:
        sink.sample(10, random_state=0, gc_strategy=[], method="sobol", executor="cuda")
    message = str(err.value)
    assert "method=None" in message and "int32 and bool values" in message
    assert "copula" in message and "QuantileTransform" in message
    assert "no integer or boolean" not in message


@pytest.fixture
def float64():
    config.set_dtype(torch.float64)
    try:
        yield
    finally:
        config.set_dtype(torch.float32)


def test_float64_mode_uses_exact_quantiles(float64):
    q = np.array([[1e-9], [0.3], [0.5]])
    out = Distribution("norm", loc=1.0, scale=2.0).sample_from_quantiles(q)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), 1.0 + 2.0 * scipy.special.ndtri(q[:, 0]), rtol=1e-14)
    ints = (tg.Constant(3) + Distribution("uniform")).sample(4, random_state=0)
    assert ints.dtype == torch.float64


def test_device_is_explicit_and_defaults_to_cpu():
    # The default is the card (a fresh process checks it in
    # test_torch_correlation.py); these tests ask for the CPU themselves.
    assert config.DEFAULT_DEVICE == torch.device("cuda")
    assert config.device() == torch.device("cpu")
    try:
        assert config.set_device("meta") == torch.device("meta")
        assert config.device().type == "meta"
    finally:
        config.set_device("cpu")
    with pytest.raises(ValueError):
        config.set_dtype(torch.int32)


def test_jax_is_not_switched_by_the_port():
    # The port shares the process with JAX in these tests; its config
    # must not touch JAX's.
    assert not jax.config.read("jax_enable_x64")
