"""The port's Sobol' indices (``engine/sensitivity.py::sobol_indices``) on
the CPU: the pick-freeze estimators against the JAX package's on the same
A and B, the Ishigami function's first-order, total and second-order
indices, a path node as a factor, and the refusals.

Parity: both packages' estimators (the JAX package's ``_build_sobol_fn``
with its quantile generator handing it the test's matrix) on one pair of
float32-exact base matrices; the mean and variance within 1e-5 of
max(1, |value|) and the indices within 1e-4 in float32 (sums of 2^13
float32 terms in different orders), 1e-10 in float64.  The analytic
tolerances are the JAX package's own (``tests/test_sensitivity.py:459``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from probabilit_tpu import config as jax_config
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import sensitivity as jax_sens
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jg
from probabilit_tpu.ops import qmc as jax_qmc
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import sensitivity as sens
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

TOL = {"float32": (1e-5, 1e-4), "float64": (1e-10, 1e-10)}  # (moments, indices)
N = 1 << 13


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.fixture(params=["float32", "float64"])
def both_dtypes(request):
    config.set_dtype(getattr(torch, request.param))
    jax_config.set_dtype(getattr(jnp, request.param))
    try:
        yield request.param
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)


def _ishigami(pkg, graph):
    xs = [pkg.Distribution("uniform", loc=-np.pi, scale=2 * np.pi) for _ in range(3)]
    x1, x2, x3 = xs
    return graph.Sin(x1) + 7 * graph.Sin(x2) ** 2 + 0.1 * x3**4 * graph.Sin(x1), xs


def _with_path():
    g = jax_pkg.GeometricBrownianMotion(s0=100.0, mu=0.03, sigma=0.2, steps=8)
    x = jax_pkg.Distribution("lognorm", 0.3, scale=2.0)
    return g.average() * x + jax_pkg.Distribution("norm"), [g, x]


SINKS = {
    "ishigami": lambda: _ishigami(jax_pkg, jg),
    "mixed_dag_20": lambda: (jax_benchmarks.mixed_dag_20(), None),
    "path_node": _with_path,
}


@pytest.mark.parametrize("name,second_order,both_dtypes", [
    ("ishigami", True, "float32"), ("ishigami", True, "float64"),
    ("mixed_dag_20", False, "float32"), ("path_node", True, "float32"),
    ("path_node", True, "float64"),
], indirect=["both_dtypes"])
def test_estimators_match_jax_on_the_same_matrices(name, second_order, both_dtypes, monkeypatch):
    sink, wrt = SINKS[name]()
    plan = jax_compile.get_plan(sink)
    variables = list(plan.isns) if wrt is None else wrt
    cols = tuple(plan.columns_of(v) for v in variables)
    k = len(cols)
    pairs = tuple((i, j) for i in range(k) for j in range(i + 1, k)) if second_order else ()
    d = plan.d_total
    AB = np.random.default_rng(11).integers(1, 2**23, (N, 2 * d)) / 2**23
    monkeypatch.setattr(jax_sens, "_SOBOL_CACHE", {})
    monkeypatch.setattr(jax_qmc, "generate", lambda *a, **kw: jnp.asarray(AB, kw.get("dtype")))
    ref = [np.asarray(v, np.float64) for v in
           jax_sens._build_sobol_fn(plan, cols, N, "sobol", pairs)(None)]
    mapping = interop.from_reference(sink)
    port_sink = mapping[sink._id]
    port_cols = tuple(tcompile.get_plan(port_sink).columns_of(mapping[v._id]) for v in variables)
    assert port_cols == cols
    A = torch.as_tensor(AB[:, :d], dtype=config.float_dtype())
    B = torch.as_tensor(AB[:, d:], dtype=config.float_dtype())
    got = [v.numpy().astype(np.float64) for v in
           sens._build_sobol_fn(tcompile.get_plan(port_sink), port_cols, pairs)(A, B)]
    mtol, itol = TOL[both_dtypes]
    for r, g in zip(ref[:2], got[:2]):  # mean, variance
        assert abs(g - r) <= mtol * max(1.0, abs(r)), (g, r)
    for r, g in zip(ref[2:], got[2:]):  # first, total, closed pairs
        np.testing.assert_allclose(g, r, rtol=0, atol=itol)


def test_ishigami_first_order_and_total_indices():
    # Ishigami & Homma (1990), a = 7, b = 0.1: S = [0.3139, 0.4424, 0],
    # ST = [0.5576, 0.4424, 0.2437], variance 13.844.
    f, xs = _ishigami(pt, pt)
    res = pt.sobol_indices(f, size=32768, random_state=1)
    for x, ts, tt in zip(xs, [0.3139, 0.4424, 0.0], [0.5576, 0.4424, 0.2437]):
        assert res.first_order[x] == pytest.approx(ts, abs=0.01)
        assert res.total_order[x] == pytest.approx(tt, abs=0.01)
    assert res.variance == pytest.approx(13.844, rel=0.02)
    assert res[xs[0]] == (res.first_order[xs[0]], res.total_order[xs[0]])
    assert res.second_order is None and "S=" in repr(res)


def test_ishigami_second_order():
    # All of the non-additive variance is the x1-x3 interaction:
    # S_13 = 8 b^2 pi^8 / (225 V) = 0.2437; S_12 = S_23 = 0.
    f, (x1, x2, x3) = _ishigami(pt, pt)
    res = f.sobol_indices(size=16384, random_state=0, second_order=True)
    assert res.second_order[(x1, x3)] == pytest.approx(0.2437, abs=0.05)
    assert res.second_order[(x3, x1)] == res.second_order[(x1, x3)]
    assert abs(res.second_order[(x1, x2)]) < 0.05 and abs(res.second_order[(x2, x3)]) < 0.05
    assert "S(" in repr(res)


@pytest.mark.parametrize("method", [None, "sobol"])
def test_linear_and_interaction_models(method):
    a = pt.Distribution("norm", loc=0.0, scale=2.0)
    b = pt.Distribution("norm", loc=0.0, scale=1.0)
    res = pt.sobol_indices(a + b, size=32768, random_state=3, method=method)
    assert res.first_order[a] == pytest.approx(0.8, abs=0.03)
    assert res.total_order[b] == pytest.approx(0.2, abs=0.03)
    assert res.variance == pytest.approx(5.0, rel=0.05)
    inter = pt.sobol_indices(a * b, size=16384, random_state=2, method=method)
    assert inter.first_order[a] == pytest.approx(0.0, abs=0.05)
    assert inter.total_order[a] == pytest.approx(1.0, abs=0.05)


def test_path_node_as_a_factor():
    """A path node swaps its whole column set: S(gbm) + S(x) = 1 for
    gbm.terminal() + x, with var(S_T) = s0^2 e^{2 mu T}(e^{sigma^2 T} - 1)."""
    g = pt.GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=8)
    x = pt.Distribution("norm", loc=0.0, scale=10.0)
    res = pt.sobol_indices(g.terminal() + x, size=16384, random_state=0)
    assert res.variables == [g, x]
    v_g = 100.0**2 * np.exp(0.1) * (np.exp(0.04) - 1.0)
    want = v_g / (v_g + 100.0)
    assert res.first_order[g] == pytest.approx(want, abs=0.03)
    assert res.total_order[x] == pytest.approx(1.0 - want, abs=0.03)
    sub = pt.sobol_indices(g.terminal() + x, wrt=[x], size=4096, random_state=0)
    assert sub.variables == [x]


def test_refusals():
    a = pt.Distribution("norm")
    b = pt.Distribution("norm")
    s = a + b
    s.correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
    with pytest.raises(ValueError, match="independent inputs"):
        pt.sobol_indices(s, size=1024)
    c, d = pt.Distribution("norm"), pt.Distribution("norm")
    with pytest.raises(ValueError, match="not a distribution node"):
        pt.sobol_indices(c + d, wrt=[c + d], size=1024)
    with pytest.raises(ValueError, match="appears twice"):
        pt.sobol_indices(c + d, wrt=[c, c], size=1024)
    with pytest.raises(ValueError, match="wrt is empty"):
        pt.sobol_indices(c + d, wrt=[], size=1024)
    with pytest.raises(ValueError, match="too small"):
        pt.sobol_indices(c + d, size=3)
    with pytest.raises(ValueError, match="at least two variables"):
        pt.sobol_indices(c + 0 * d, wrt=[c], size=1024, second_order=True)
    with pytest.raises(FloatingPointError, match="constant"):
        pt.sobol_indices(0 * c + 1.0, size=1024, random_state=0)
    with pytest.raises(ValueError, match="non-numeric"):
        pt.sobol_indices(pt.DiscreteDistribution(["x", "y"]), size=1024)
