"""The port's closed-form ppf families against the JAX package and scipy.

Every closed-form family the JAX package registers (the megakernel's
closed-form whitelist, anglit and wrapcauchy, and the discrete bernoulli,
geom and randint), at the parameters of its family sweep
(``tests/test_distributions.py``), on the float32 quantile grid ``Q`` of
``tests/test_torch_special_ppf.py``.  The JAX side runs under
``jax.jit``.  Tolerances:

* q in [0.01, 0.99]: at most ``ULP_TOL`` float32 ulps of the largest JAX
  value there (4, as in ``test_torch_special_ppf.py``), except where a
  family's formula amplifies rounding: alpha (1 / (a - ndtri(.))
  cancels, measured 13 ulps) and levy_l (1 / z^2 as z -> 0, measured 46);
* the tails: 1e-3 on the standard-normal score (the error times the
  family's density over the normal density at ndtri(q)), or, for the
  bounded families whose tail density vanishes, at most ``TAIL_ULPS``
  ulps of the JAX value (measured at most 9, truncweibull_min);
* the discrete families exactly;
* float64 against ``scipy.stats`` over q in [0.001, 0.999]: 1e-9 of the
  largest value (measured at most 4.4e-14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu_torch import config
from probabilit_tpu_torch.ops import ppf
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


_K = np.unique(np.round(np.logspace(0, 16.5, 200, base=2)))
Q = np.concatenate(
    [
        [2.0**-24],
        _K * 2.0**-23,
        1.0 - _K * 2.0**-23,
        [1.0 - 2.0**-24],
        np.logspace(-5, -2, 300),
        1.0 - np.logspace(-5, -2, 300),
        np.linspace(0.01, 0.99, 2001),
    ]
).astype(np.float32)
CENTRAL = (Q >= 0.01) & (Q <= 0.99)

ULP_TOL = 4
FAMILY_ULP_TOL = {"alpha": 16, "levy_l": 64}
TAIL_ABS_TOL = 1e-3  # on the standard score
TAIL_ULPS = 16
F64_TOL = 1e-9

# (family, args, kwargs): tests/test_distributions.py's sweep.
CLOSED_FORM = [
    ("truncnorm", (-1.0, 2.0), {"loc": 0.5, "scale": 1.5}),
    ("cauchy", (), {"loc": 1, "scale": 2}),
    ("laplace", (), {"loc": 0, "scale": 1.5}),
    ("logistic", (), {"loc": 2, "scale": 0.5}),
    ("gumbel_r", (), {"loc": 1, "scale": 2}),
    ("gumbel_l", (), {"loc": 1, "scale": 2}),
    ("rayleigh", (), {"scale": 2}),
    ("halfnorm", (), {"scale": 1.5}),
    ("pareto", (2.5,), {}),
    ("weibull_min", (1.7,), {"scale": 2}),
    ("weibull_max", (1.7,), {"scale": 2}),
    ("powerlaw", (2.0,), {}),
    ("loguniform", (0.01, 10.0), {}),
    ("arcsine", (), {}),
    ("hypsecant", (), {}),
    ("fisk", (2.0,), {}),
    ("genpareto", (0.3,), {}),
    ("genextreme", (0.2,), {}),
    ("alpha", (2.0,), {}),
    ("anglit", (), {}),
    ("bradford", (1.5,), {}),
    ("burr", (2.5, 1.5), {}),
    ("burr12", (2.0, 3.0), {}),
    ("dweibull", (1.8,), {}),
    ("exponpow", (1.7,), {}),
    ("exponweib", (2.0, 1.5), {}),
    ("fatiguelife", (0.5,), {}),
    ("genhalflogistic", (0.8,), {}),
    ("genlogistic", (2.5,), {}),
    ("gibrat", (), {}),
    ("gompertz", (1.2,), {}),
    ("halfcauchy", (), {}),
    ("halflogistic", (), {}),
    ("invweibull", (2.5,), {}),
    ("johnsonsb", (1.0, 2.0), {}),
    ("johnsonsu", (1.0, 2.0), {}),
    ("kappa3", (2.0,), {}),
    ("laplace_asymmetric", (1.5,), {}),
    ("levy", (), {}),
    ("levy_l", (), {}),
    ("loglaplace", (2.5,), {}),
    ("lomax", (2.5,), {}),
    ("mielke", (3.0, 2.0), {}),
    ("moyal", (), {}),
    ("powerlognorm", (2.0, 0.8), {}),
    ("powernorm", (2.5,), {}),
    ("trapezoid", (0.2, 0.7), {}),
    ("truncexpon", (3.0,), {}),
    ("truncpareto", (2.0, 5.0), {}),
    ("truncweibull_min", (1.5, 0.5, 3.0), {}),
    ("tukeylambda", (0.5,), {}),
    ("tukeylambda", (-0.2,), {}),
    ("wrapcauchy", (0.5,), {}),
    ("reciprocal", (0.01, 10.0), {}),
    ("skewcauchy", (0.5,), {}),
    ("skewcauchy", (-0.7,), {}),
    ("kappa4", (1.0, 2.0), {}),
    ("kappa4", (0.0, 0.5), {}),
    ("kappa4", (2.0, 0.0), {}),
    ("kappa4", (0.0, 0.0), {}),
    ("kappa4", (-0.5, -0.3), {}),
    ("crystalball", (1.5, 3.0), {}),
    ("crystalball", (0.5, 2.0), {}),
]
DISCRETE = [
    ("bernoulli", (0.3,), {}),
    ("geom", (0.25,), {}),
    ("randint", (2, 9), {}),
]


def _id(case):
    name, args, _ = case
    return name + "".join(f"-{a:g}" for a in args)


def _jax(name, args, kwargs, q):
    return np.asarray(jax.jit(lambda q: jax_ppf.call(name, q, *args, **kwargs))(jnp.asarray(q)))


def _port(name, args, kwargs, q):
    return ppf.call(name, torch.from_numpy(q), *args, **kwargs).numpy()


@pytest.mark.parametrize("case", CLOSED_FORM, ids=_id)
def test_closed_form_family_matches_jax(case):
    name, args, kwargs = case
    ref = _jax(name, args, kwargs, Q)
    got = _port(name, args, kwargs, Q)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    err = np.abs(ref.astype(np.float64) - got)
    scale = np.spacing(np.abs(ref[CENTRAL]).max())
    assert err[CENTRAL].max() <= FAMILY_ULP_TOL.get(name, ULP_TOL) * scale
    # The tails: the error on the standard-score scale, or in ulps of the
    # value where the family's tail density vanishes (bounded supports).
    tail = ~CENTRAL
    dist = getattr(scipy.stats, name)(*args, **kwargs)
    z = scipy.special.ndtri(Q[tail].astype(np.float64))
    with np.errstate(all="ignore"):
        score_err = err[tail] * dist.pdf(ref[tail].astype(np.float64)) / scipy.stats.norm.pdf(z)
    ulps = err[tail] / np.spacing(np.abs(ref[tail]))
    ok = (err[tail] == 0) | (score_err <= TAIL_ABS_TOL) | (ulps <= TAIL_ULPS)
    assert ok.all(), list(zip(Q[tail][~ok], ref[tail][~ok], got[~CENTRAL][~ok]))


@pytest.mark.parametrize("case", DISCRETE, ids=_id)
def test_discrete_family_equals_jax(case):
    name, args, kwargs = case
    np.testing.assert_array_equal(_port(name, args, kwargs, Q), _jax(name, args, kwargs, Q))
    np.testing.assert_array_equal(
        _port(name, args, {"loc": 3}, Q), _jax(name, args, {"loc": 3}, Q)
    )


@pytest.mark.parametrize("case", CLOSED_FORM + DISCRETE, ids=_id)
def test_float64_matches_scipy(case):
    name, args, kwargs = case
    q = np.linspace(0.001, 0.999, 2001)
    config.set_dtype(torch.float64)
    try:
        got = ppf.call(name, torch.from_numpy(q), *args, **kwargs).numpy()
    finally:
        config.set_dtype(torch.float32)
    assert got.dtype == np.float64
    ref = getattr(scipy.stats, name)(*args, **kwargs).ppf(q)
    assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max()


def test_closed_forms_take_tensor_parameters():
    q = torch.from_numpy(Q[CENTRAL][:64])
    c = torch.linspace(0.1, 0.9, 64)
    got = ppf.call("genpareto", q, c, loc=torch.linspace(-1.0, 1.0, 64), scale=2.0).numpy()
    ref = np.asarray(
        jax_ppf.call(
            "genpareto", jnp.asarray(q.numpy()), jnp.asarray(c.numpy()),
            loc=jnp.linspace(-1.0, 1.0, 64, dtype=jnp.float32), scale=2.0,
        )
    )
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_every_registered_family_is_swept():
    """The 97 families: these, the Newton file's, the first five of
    ``test_torch_special_ppf.py``, and the table tier's ``poisson``,
    ``binom`` and ``nbinom`` (``test_torch_ppf_tables.py``)."""
    from test_torch_ppf_newton import NEWTON, SAFEGUARDED
    from test_torch_ppf_tables import TABLE_FAMILIES
    from test_torch_special_ppf import FAMILIES

    tables = {c[0] for c in TABLE_FAMILIES} & {"poisson", "binom", "nbinom"}
    swept = {c[0] for c in CLOSED_FORM + DISCRETE + NEWTON + SAFEGUARDED} | {f[0] for f in FAMILIES}
    swept |= tables
    assert tables == {"poisson", "binom", "nbinom"} <= set(ppf.families())
    assert swept == set(ppf.families())
    assert len(swept) == 97
    assert set(jax_ppf._REGISTRY) - swept == set()
