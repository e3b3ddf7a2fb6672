"""The port's (family, slot) grid of sensitivities against the JAX package's,
the refusal of a shape slot reached through a graph parameter, ``random_state``
given as a numpy ``RandomState`` (C6), and the kernels' absence from the
gradient path, on the CPU.

The grid holds each family's value and gradient on one explicit matrix
(``test_torch_sensitivity.py``'s helpers and float32 tolerances) where the
JAX package differentiates, and a ``ValueError`` from both packages where
it refuses: gamma's, beta's and t's shape slots (a Newton ``while_loop``
without reverse mode; ``betainc``'s a and b), a discrete family, a
quantile-table family and one without a native kernel.
"""

import numpy as np
import pytest

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from probabilit_tpu.engine import sensitivity as jax_sens
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, sensitivity as sens
from probabilit_tpu_torch.engine.sampler import resolve_seed
from test_torch_sensitivity import (  # noqa: F401  (the fixtures are used by name)
    N,
    _assert_parity,
    _jax_value_and_grad,
    _port_value_and_grad,
    on_the_cpu,
    vector_math_initialised,
)
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)


# --- the (family, slot) grid ------------------------------------------------------------

# (family, args, kwargs, slot): closed forms, and each shape slot of the
# three Newton families the JAX package cannot differentiate, with loc
# and scale alone.
GRID = [
    ("lognorm", (0.5,), {"loc": 0.3, "scale": 1.7}, 0),
    ("triang", (0.3,), {"loc": 0.3, "scale": 1.7}, 0),
    ("weibull_min", (1.7,), {"loc": 0.3, "scale": 2.0}, 0),
    ("genpareto", (0.3,), {"loc": 0.3, "scale": 1.7}, 0),
    ("genextreme", (0.2,), {"loc": 0.3, "scale": 1.7}, 0),
    ("invgauss", (1.5,), {"loc": 0.3, "scale": 2.0}, "scale"),
    ("gamma", (2.5,), {"loc": 0.3, "scale": 1.5}, 0),
    ("gamma", (2.5,), {"loc": 0.3, "scale": 1.5}, ("loc", "scale")),
    ("beta", (2.0, 3.0), {"loc": 0.3, "scale": 1.7}, 0),
    ("beta", (2.0, 3.0), {"loc": 0.3, "scale": 1.7}, 1),
    ("beta", (2.0, 3.0), {"loc": 0.3, "scale": 1.7}, ("loc", "scale")),
    ("t", (7.0,), {"loc": 0.3, "scale": 1.7}, 0),
    ("t", (), {"df": 7.0, "loc": 0.3, "scale": 1.7}, "df"),
    ("t", (7.0,), {"loc": 0.3, "scale": 1.7}, ("loc", "scale")),
    ("poisson", (3.0,), {}, 0),  # discrete
    ("ncx2", (2.0, 1.5), {}, 0),  # a quantile table in the port, a callback there
    ("genhyperbolic", (0.5, 1.5, 0.5), {}, 0),  # no native kernel in either package
]


def _grid_id(case):
    name, args, kwargs, slot = case
    slot = "+".join(slot) if isinstance(slot, tuple) else slot
    return f"{name}{list(args) or ''}-{slot}"


def _outcome(run):
    try:
        return run()
    except ValueError as exc:
        return f"ValueError: {str(exc)[:40]}"


@pytest.mark.parametrize("case", GRID, ids=_grid_id)
def test_family_slot_grid_matches_jax(case):
    """Where the JAX package differentiates, the same value and gradients
    on one explicit matrix; where it raises a ValueError (before or while
    tracing), the port raises one before any draw."""
    name, args, kwargs, slots = case
    slots = list(slots) if isinstance(slots, tuple) else [slots]
    q = 0.001 + 0.998 * np.random.default_rng(5).integers(1, 2**23, (N, 1)) / 2**23
    ref_node = jax_pkg.Distribution(name, *args, **kwargs)

    def reference():
        jax_sens._validate_family(ref_node)
        pairs = [(ref_node, slot) for slot in slots]
        return _jax_value_and_grad(ref_node, pairs, ["mean"], q, False)["mean"]

    port_node = pt.Distribution(name, *args, **kwargs)

    def port():
        plan = tcompile.get_plan(port_node)
        pairs = sens._normalize_wrt(plan, {port_node: slots})
        sens._refuse_untraceable(plan, pairs)
        return _port_value_and_grad(port_node, pairs, "mean", q, False)

    ref, got = _outcome(reference), _outcome(port)
    if isinstance(ref, str):
        assert isinstance(got, str), (ref, got)
        with pytest.raises(ValueError):
            pt.sensitivity(port_node, wrt={port_node: slots}, size=64, random_state=0)
    else:
        _assert_parity(ref, got, "float32")


def test_refused_slot_reached_through_a_node_parameter():
    """A targeted node that feeds gamma's shape meets the Newton loop the JAX
    package cannot differentiate: both refuse; gamma's scale is fine."""
    x = jax_pkg.Distribution("norm", loc=3.0, scale=0.1)
    with pytest.raises(ValueError):
        jax_sens.sensitivity(jax_pkg.Distribution("gamma", x), wrt=x, size=64, random_state=0)
    px = pt.Distribution("norm", loc=3.0, scale=0.1)
    with pytest.raises(ValueError, match="'a' is not available"):
        pt.sensitivity(pt.Distribution("gamma", px), wrt=px, size=64, random_state=0)
    res = pt.sensitivity(pt.Distribution("gamma", 2.0, scale=px), wrt=px, size=4096,
                         random_state=0)
    assert res[(px, "loc")] == pytest.approx(2.0, rel=0.05)  # E = a * scale


# --- C6: a numpy RandomState ------------------------------------------------------------


def _entry_points():
    x = pt.Distribution("norm", loc=1.0, scale=2.0)
    return {
        "sample": lambda rs: float(x.sample(256, random_state=rs).mean()),
        "estimate": lambda rs: pt.estimate(x, 1024, block_size=256, random_state=rs,
                                           executor=None)["mean"],
        "sensitivity": lambda rs: pt.sensitivity(x, wrt=x, size=256, random_state=rs).value,
        "sobol_indices": lambda rs: pt.sobol_indices(x + pt.Distribution("norm"), size=256,
                                                     random_state=rs).variance,
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_random_state_accepts_a_numpy_random_state(entry):
    """C6: a RandomState seeds the run with one ``randint(2**31)`` draw and
    is advanced by it, as the JAX package's ``resolve_key`` does."""
    run = _entry_points()[entry]
    rs = np.random.RandomState(0)
    got = run(rs)
    assert got == run(int(np.random.RandomState(0).randint(2**31)))
    advanced = np.random.RandomState(0)
    jax_pkg.Distribution("norm").sample(4, random_state=advanced)  # the JAX package's draw
    assert rs.randint(2**31) == advanced.randint(2**31)


def test_resolve_seed_of_each_random_state_kind():
    assert resolve_seed(7) == 7 and resolve_seed(np.int64(7)) == 7
    assert resolve_seed(np.random.RandomState(3)) == np.random.RandomState(3).randint(2**31)
    assert resolve_seed(np.random.default_rng(3)) == np.random.default_rng(3).integers(2**63)
    with pytest.raises(TypeError, match="Cannot interpret random_state"):
        resolve_seed("seed")


def test_no_kernel_on_the_gradient_path():
    """The gradient and Sobol' paths call the plain body: K1 and K2 never."""
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20

    launches, stats = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    sink = mixed_dag_20()
    isns = tcompile.get_plan(sink).isns
    pt.sensitivity(sink, wrt=isns, size=2048, random_state=0)
    pt.sensitivity(sink, wrt=isns[:2], size=2048, random_state=0, block_size=512)
    pt.sobol_indices(sink, size=256, random_state=0)
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == (launches, stats)


@pytest.mark.parametrize("name,args", [("poisson", (3.5,)), ("binom", (12, 0.3)),
                                       ("nbinom", (4, 0.35)), ("lognorm", (0.5,)),
                                       ("gamma", (2.5,))], ids=lambda v: str(v))
def test_tensor_parameters_give_the_float_parameters_values(name, args):
    """``ppf._is_static`` sends a tensor parameter down another branch than
    a number (the discrete families' bisection against their CDF tables):
    a swapped-in parameter that requires grad gives the same samples."""
    import torch

    from probabilit_tpu_torch.ops import ppf

    q = torch.from_numpy(np.random.default_rng(0).integers(1, 2**23, 1 << 15) / 2**23).float()
    with_numbers = ppf.call(name, q, *args)
    with_tensors = ppf.call(name, q, *[torch.tensor(float(v), requires_grad=True) for v in args])
    torch.testing.assert_close(with_tensors.detach(), with_numbers, rtol=0, atol=0)


def test_no_cache_keeps_an_earlier_parameter_value():
    """A second call after a parameter changed sees the new value: E[x^2]
    of N(loc, 1) has d/dloc = 2 loc."""
    x = pt.Distribution("norm", loc=1.0, scale=1.0)
    y = x * x
    first = pt.sensitivity(y, wrt={x: ["loc"]}, size=2**14, random_state=0)
    x.kwargs["loc"] = 3.0
    second = pt.sensitivity(y, wrt={x: ["loc"]}, size=2**14, random_state=0)
    assert first[(x, "loc")] == pytest.approx(2.0, rel=0.02)
    assert second[(x, "loc")] == pytest.approx(6.0, rel=0.02)
    assert second.value == pytest.approx(first.value + 8.0, rel=0.02)
