"""The port's parameter sensitivities (``engine/sensitivity.py``) on the CPU:
slots and validation, value and gradients against the JAX package's, the
(family, slot) refusals, and ``random_state`` given as a numpy
``RandomState``.

Parity runs both packages on one explicit quantile matrix: the JAX
package's ``jax.value_and_grad`` of its statistic over its own
``compile.build_body`` (as its ``_build_grad_fn`` builds it) against the
port's ``_build_grad_fn``, in float32 and float64, for every statistic on
a closed-form graph (``mixed_dag_20``, 16 slots), a correlated graph (the
sort-free recolouring on drawn uniforms) and a path node (its slab on an
explicit matrix).  Tolerances: the value within 1e-5 (float32) or 1e-11
(float64) of max(1, |value|), each gradient within 1e-4 (float32) or
1e-9 (float64) of max(1, the largest |gradient|); both packages sum
float32 samples in different orders, and the correlated graph's
recolouring solves a K x K system from the sample covariance.
"""

import jax
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
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, sensitivity as sens
from probabilit_tpu_torch.engine.sampler import resolve_seed
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

TOL = {"float32": (1e-5, 1e-4), "float64": (1e-11, 1e-9)}  # (value, gradient)
N = 1 << 12
STATISTICS = ["mean", "var", "std", "q0.9", "cvar0.9", "callable"]


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
    """Both packages in one float mode (JAX's float64 is ``jax_enable_x64``)."""
    config.set_dtype(getattr(torch, request.param))
    jax_config.set_dtype(getattr(jnp, request.param))
    try:
        yield request.param
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)


def _square_mean(x):
    """A callable statistic both packages differentiate (operators only)."""
    return (x * x).mean()


def _jax_value_and_grad(sink, pairs, statistics, q, drawn):
    """The JAX package's value and gradients of each statistic on the
    explicit matrix ``q``: its ``_build_grad_fn`` with the draw taken out,
    every statistic in one program (``jax.jacrev`` of their vector)."""
    plan = jax_compile.get_plan(sink)
    correlator = jax_compile.resolve_correlator("imanconover")
    generated = drawn and jax_compile.recolor_eligible(plan, correlator)
    body = jax_compile.build_body(plan, correlator, keep_ids=frozenset([sink._id]),
                                  check_finite=False, generated_ok=generated)
    stats = [_square_mean if s == "callable" else jax_sens._resolve_statistic(s)[0]
             for s in statistics]
    gen_key = jax.random.PRNGKey(0) if drawn else None

    def values_of(theta):
        saved = jax_sens._save_slots(pairs)
        try:
            for (node, slot), th in zip(pairs, theta):
                jax_sens._write_slot(node, slot, th)
            outputs, _ = body(jnp.asarray(q), gen_key=gen_key)
            x = outputs[sink._id]
            v = jnp.stack([stat(x) for stat in stats])
            return v, v
        finally:
            jax_sens._restore_slots(saved)

    theta0 = jnp.asarray([float(jax_sens._read_slot(n, s)) for n, s in pairs],
                         jax_config.float_dtype())
    grads, values = jax.jit(jax.jacrev(values_of, has_aux=True))(theta0)
    return {s: (float(values[i]), np.asarray(grads[i], np.float64))
            for i, s in enumerate(statistics)}


def _port_value_and_grad(sink, pairs, statistic, q, drawn):
    plan = tcompile.get_plan(sink)
    stat = _square_mean if statistic == "callable" else sens._resolve_statistic(statistic)[0]
    fn = sens._build_grad_fn(plan, pairs, stat, tcompile.resolve_correlator("imanconover"), drawn)
    theta0 = torch.tensor([float(sens._read_slot(n, s)) for n, s in pairs],
                          dtype=config.float_dtype())
    value, grad = fn(theta0, torch.as_tensor(q, dtype=config.float_dtype()))
    return float(value), grad.numpy().astype(np.float64)


def _assert_parity(ref, got, dtype):
    vtol, gtol = TOL[dtype]
    (rv, rg), (gv, gg) = ref, got
    assert np.isfinite(rv) and np.all(np.isfinite(rg))
    assert abs(gv - rv) <= vtol * max(1.0, abs(rv)), (gv, rv)
    scale = max(1.0, float(np.abs(rg).max()))
    np.testing.assert_allclose(gg, rg, rtol=0, atol=gtol * scale)


def _closed_form():
    sink = jax_benchmarks.mixed_dag_20()
    nodes = [n for n in jax_compile.get_plan(sink).isns]
    return sink, [(node, slot) for node in nodes for slot in jax_sens._numeric_slots(node)], True


def _correlated():
    a = jax_pkg.Distribution("norm", loc=1.0, scale=2.0)
    b = jax_pkg.Distribution("lognorm", 0.4, scale=3.0)
    c = jax_pkg.Distribution("triang", 0.3, loc=-1.0, scale=4.0)
    sink = a * b + c
    target = np.array([[1.0, 0.5, -0.3], [0.5, 1.0, 0.2], [-0.3, 0.2, 1.0]])
    sink.correlate(a, b, c, corr_mat=target)
    return sink, [(a, "loc"), (a, "scale"), (b, 0), (b, "scale"), (c, 0), (c, "scale")], True


def _path():
    g = jax_pkg.GeometricBrownianMotion(s0=100.0, mu=0.03, sigma=0.2, steps=8)
    x = jax_pkg.Distribution("norm", loc=1.0, scale=0.1)
    sink = g.average() * x
    return sink, [(g, "s0"), (g, "mu"), (g, "sigma"), (x, "scale")], False


GRAPHS = {"closed_form": _closed_form, "correlated": _correlated, "path": _path}
_REFERENCE = {}


def _reference(graph, dtype):
    """(sink, pairs, drawn, q, {statistic: JAX value and gradients}), once
    per graph and float mode (one JAX compile for the six statistics)."""
    if (graph, dtype) not in _REFERENCE:
        sink, pairs, drawn = GRAPHS[graph]()
        plan = jax_compile.get_plan(sink)
        q = np.random.default_rng(7).integers(1, 2**23, (N, plan.d if drawn else plan.d_total))
        q = q / 2**23
        ref = _jax_value_and_grad(sink, pairs, STATISTICS, q, drawn)
        _REFERENCE[(graph, dtype)] = (sink, pairs, drawn, q, ref)
    return _REFERENCE[(graph, dtype)]


@pytest.mark.parametrize("statistic", STATISTICS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_value_and_gradients_match_jax(graph, statistic, both_dtypes):
    sink, pairs, drawn, q, ref = _reference(graph, both_dtypes)
    mapping = interop.from_reference(sink)
    port_pairs = [(mapping[node._id], slot) for node, slot in pairs]
    got = _port_value_and_grad(mapping[sink._id], port_pairs, statistic, q, drawn)
    _assert_parity(ref[statistic], got, both_dtypes)


def test_joint_node_indexed_slots_match_jax(both_dtypes):
    """A basket delta over a joint node's indexed slots, on its slab."""
    a, b = jax_pkg.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], [[1, 0.6], [0.6, 1]],
                                 steps=8)
    sink = 0.5 * a.terminal() + 0.5 * b.terminal()
    pairs = [(a.joint, s) for s in ("s0[0]", "s0[1]", "mu[1]", "sigma[0]")]
    q = np.random.default_rng(3).integers(1, 2**23, (N, jax_compile.get_plan(sink).d_total)) / 2**23
    ref = _jax_value_and_grad(sink, pairs, ["mean"], q, False)["mean"]
    mapping = interop.from_reference(sink)
    got = _port_value_and_grad(mapping[sink._id], [(mapping[a.joint._id], s) for _, s in pairs],
                               "mean", q, False)
    _assert_parity(ref, got, both_dtypes)


def test_sensitivity_value_is_the_sample_statistic():
    """method=None draws sample()'s uniforms: the value is the sampled mean,
    and d/dloc of 5x + 1 is 5 exactly."""
    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    y = 5 * x + 1
    res = pt.sensitivity(y, wrt=x, size=20000, random_state=0)
    assert res.value == pytest.approx(float(y.sample(20000, random_state=0).mean()), rel=1e-6)
    assert res[(x, "loc")] == pytest.approx(5.0, abs=1e-6)
    assert abs(res[(x, "scale")]) < 0.1
    assert "d/d(" in repr(res) and res.sems is None and res.value_sem is None
    assert y.sensitivity(x, size=20000, random_state=0).gradients == res.gradients


@pytest.mark.parametrize("n", [1000, 1001])
@pytest.mark.parametrize("level", [0.001, 0.25, 0.5, 0.9, 0.999])
def test_sort_quantile_matches_jnp_quantile(level, n):
    """``_quantile`` is ``jnp.quantile``'s linear interpolation: the same
    float32 value, and the same two interpolation weights as gradient."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(lambda v: jnp.quantile(v, level))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = sens._quantile(t, level)
    (grad,) = torch.autograd.grad(got, t)
    assert float(got.detach()) == float(ref)
    np.testing.assert_array_equal(grad.numpy(), np.asarray(ref_grad))


# --- slots, swaps and validation --------------------------------------------------------


def test_numeric_slots_and_normalized_pairs():
    x = pt.Distribution("lognorm", 0.5, loc=1.0, scale=2.0)
    y = pt.Distribution("norm", loc=x, scale=1.0)
    plan = tcompile.get_plan(x + y)
    assert sens._numeric_slots(x) == [0, "loc", "scale"]
    assert sens._numeric_slots(y) == ["scale"]  # a Node-valued parameter is graph
    assert sens._normalize_wrt(plan, {x: ["scale"], y: ["scale"]}) == [(x, "scale"), (y, "scale")]
    g = pt.GeometricBrownianMotion(s0=100, mu=0.03, sigma=0.2, steps=4)
    assert sens._numeric_slots(g) == ["s0", "mu", "sigma"]
    a, _ = pt.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], [[1, 0.6], [0.6, 1]], steps=4)
    assert sens._numeric_slots(a.joint)[:2] == ["s0[0]", "s0[1]"]
    assert sens._parse_slot("s0[1]") == ("s0", 1) and sens._parse_slot("mu") == ("mu", None)


def test_indexed_slot_swaps_out_of_place_and_restores_the_numpy_object():
    a, b = pt.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], [[1, 0.6], [0.6, 1]], steps=4)
    joint = a.joint
    s0, mu, signature = joint.s0, joint.mu, joint._static_signature()
    before = s0.copy()
    pairs = [(joint, "s0[1]"), (joint, "s0[0]")]
    theta = torch.tensor([55.0, 105.0], requires_grad=True)

    def inside():
        assert isinstance(joint.s0, torch.Tensor) and joint.s0 is not s0
        assert joint.s0.tolist() == [105.0, 55.0]
        assert isinstance(joint.mu, torch.Tensor)  # mixes with s0 in arithmetic
        return joint.s0.sum()

    total = sens._swapped(pairs, theta, inside)
    assert torch.autograd.grad(total, theta)[0].tolist() == [1.0, 1.0]
    assert joint.s0 is s0 and joint.mu is mu and np.array_equal(s0, before)
    assert joint._static_signature() == signature
    pt.sensitivity(0.5 * a.terminal() + 0.5 * b.terminal(), wrt={joint: ["s0[1]"]},
                   size=1024, random_state=0)
    assert joint.s0 is s0 and joint._static_signature() == signature


def test_scalar_slots_restored_and_sampling_unchanged():
    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    before = x.sample(1000, random_state=1).clone()
    pt.sensitivity(x * x, wrt=x, size=1000, random_state=0)
    assert x.kwargs == {"loc": 2.0, "scale": 3.0}
    torch.testing.assert_close(x.sample(1000, random_state=1), before, rtol=0, atol=0)


def _refusal_cases():
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    other = pt.Distribution("norm")
    y = pt.Distribution("norm", loc=x, scale=1.0)
    z = pt.Distribution("norm", loc=x, scale=x)
    a = pt.Distribution("norm")
    b = pt.Distribution("norm", loc=1.0)
    corr = a + b
    corr.correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
    counts = pt.PoissonProcess(rate=2.0, steps=4)
    return {
        "discrete_family": (lambda: _sens_of(pt.Distribution("poisson", 3.0)), ValueError,
                            "is discrete"),
        "multivariate": (lambda: _sens_of(pt.Distribution("dirichlet", alpha=[1.0, 2.0])),
                         ValueError, "multivariate"),
        "host_fallback": (lambda: _sens_of(pt.Distribution("ncx2", 2.0, 1.5)), ValueError,
                          "native ppf kernel"),
        "not_a_distribution": (lambda: pt.sensitivity(x + 1, wrt=x + 1, size=64), TypeError,
                               "parametric Distribution"),
        "not_an_ancestor": (lambda: pt.sensitivity(x, wrt=other, size=64), ValueError,
                            "not an ancestor"),
        "unknown_slot": (lambda: pt.sensitivity(x, wrt={x: ["shape"]}, size=64), ValueError,
                         "no numeric scalar parameter"),
        "node_valued_slot": (lambda: pt.sensitivity(y, wrt={y: ["loc"]}, size=64), ValueError,
                             "no numeric scalar parameter"),
        "no_slots": (lambda: pt.sensitivity(z, wrt=z, size=64), ValueError,
                     "no numeric scalar parameters"),
        "empty_wrt": (lambda: pt.sensitivity(x, wrt=[], size=64), ValueError, "wrt is empty"),
        "bad_statistic": (lambda: pt.sensitivity(x, wrt=x, size=64, statistic="median"),
                          ValueError, "statistic must be"),
        "bad_level": (lambda: pt.sensitivity(x, wrt=x, size=64, statistic="q1.5"), ValueError,
                      "statistic must be"),
        "size": (lambda: pt.sensitivity(x, wrt=x, size=1), ValueError, "too small"),
        "integer_sink": (lambda: pt.sensitivity((x > 0) + 0, wrt=x, size=64), ValueError,
                         "integer-valued"),
        "method": (lambda: pt.sensitivity(x, wrt=x, size=64, method="fourier"), ValueError,
                   "method must be"),
        "qmc_correlated": (lambda: pt.sensitivity(corr, wrt=b, size=64, method="sobol"),
                           ValueError, "correlation-free"),
        "qmc_key_seeded": (lambda: pt.sensitivity(
            pt.QuantileTransform(pt.ClaytonCopula(theta=2.0)[0], "norm") + x, wrt=x, size=64,
            method="sobol"), ValueError, "column-seeded"),
        "replicates": (lambda: pt.sensitivity(x, wrt=x, size=64, replicates=1), ValueError,
                       "replicates must be"),
        "divisible": (lambda: pt.sensitivity(x, wrt=x, size=1001, replicates=4), ValueError,
                      "divisible"),
        "stream_callable": (lambda: pt.sensitivity(x, wrt=x, size=256, block_size=64,
                                                   statistic=_square_mean), ValueError,
                            "statistic='mean'"),
        "stream_cholesky": (lambda: pt.sensitivity(corr, wrt=b, size=256, block_size=64,
                                                   correlator="cholesky"), ValueError,
                            "not eligible"),
        "path_without_slots": (lambda: pt.sensitivity(counts.terminal(), wrt=counts, size=64),
                               ValueError, "declares no differentiable"),
    }


def _sens_of(node):
    return pt.sensitivity(node + 0.0, wrt=node, size=64)


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refusals(case):
    call, error, match = _refusal_cases()[case]
    with pytest.raises(error, match=match):
        call()


