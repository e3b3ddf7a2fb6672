"""The port's table tiers of ``ops/ppf.py`` against the JAX package.

The discrete CDF tables (``poisson``, ``binom``, ``nbinom`` and the
generic scipy-discrete table), their bisection for tensor parameters, the
PCHIP quantile tables of the continuous families without a function, and
the scipy host callback.  The same seeded numpy inputs go through both
packages.  Tolerances:

* the float64 CDF tables (scipy on the host in both packages): bitwise,
  with the same support start, in float32 and in float64 mode (the
  generic table's eps follows the dtype);
* the table tier's ppf: exact, in float32 and float64 (JAX under
  ``jax_enable_x64``), on seeded quantiles and on quantiles equal to the
  table's own entries (the strict side of ``searchsorted``);
* bisection on tensor parameters: exact against the static table on
  the JAX package's own cases, and against the JAX package's bisection;
* ``bird_survival`` (a binomial whose n is a Poisson node): exact;
* the PCHIP coefficients: bitwise (both are scipy in float64); its ppf
  on the same q within 4e-6 of the table's scale plus the value's
  distance from its centre (``ndtri_fast_wide``'s logs round up to 3 ulps
  apart in the two packages; measured at most 9.9e-7, landau);
* the scipy callback: equal to scipy's float64 ppf cast to float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from probabilit_tpu import config as jax_config
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.ops import ppf, special
from test_distributions import DISCRETE_FAMILIES, PCHIP_FAMILIES
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


@pytest.fixture(params=["float32", "float64"])
def dtype(request):
    """Both packages in one float dtype (JAX's float64 is ``jax_enable_x64``)."""
    name = request.param
    config.set_dtype(getattr(torch, name))
    jax_config.set_dtype(getattr(jnp, name))
    try:
        yield name
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)


def _ids(cases):
    return [f"{c[0]}{i}" for i, c in enumerate(cases)]


# The families of the JAX package's sweep that the table tier serves (the
# others have their own functions, or a table over the cap).
TABLE_FAMILIES = [
    c for c in DISCRETE_FAMILIES
    if jax_ppf.static_cdf_table(c[0], *c[1], **c[2]) is not None
]


def test_the_sweep_has_tables_for_most_discrete_families():
    names = {c[0] for c in TABLE_FAMILIES}
    assert {"poisson", "binom", "nbinom", "hypergeom", "zipf", "poisson_binom"} <= names
    assert not names & {"bernoulli", "geom", "randint", "betanbinom"}


@pytest.mark.parametrize("case", DISCRETE_FAMILIES, ids=_ids(DISCRETE_FAMILIES))
def test_static_cdf_table_matches_jax(case, dtype):
    name, args, kwargs = case
    ref = jax_ppf.static_cdf_table(name, *args, **kwargs)
    got = ppf.static_cdf_table(name, *args, **kwargs)
    assert (ref is None) == (got is None)
    if ref is not None:
        assert got[1] == ref[1]
        assert got[0].dtype == np.float64
        np.testing.assert_array_equal(got[0], ref[0])


def test_generic_table_gating():
    assert ppf.static_cdf_table("hypergeom", 30, 25, 20) is not None
    assert ppf.static_cdf_table("zipf", 3.5) is not None
    # Families with their own function keep it.
    assert ppf.static_cdf_table("geom", 0.25) is None
    assert ppf.static_cdf_table("bernoulli", 0.5) is None
    assert ppf.static_cdf_table("randint", 0, 10) is None
    # A reachable support over the cap goes to the host callback.
    assert ppf.static_cdf_table("zipf", 2.5) is None
    table, start = ppf.static_cdf_table("hypergeom", 30, 25, 20)
    assert start == 15 and len(table) == 6
    # Tensor parameters, array parameters and continuous families: no table.
    assert ppf.static_cdf_table("poisson", torch.tensor(3.0)) is None
    assert ppf.static_cdf_table("poisson", np.array([1.0, 2.0])) is None
    assert ppf.static_cdf_table("norm") is None


def _table_quantiles(name, args, kwargs, dtype):
    """Seeded quantiles on the generators' 2^-24 grid, then the table's own
    entries in the dtype (exact boundary hits), then the clamp's ends.  In
    float64 some tables exceed the cap (their eps is 2^-54): both packages
    then take scipy's callback."""
    rng = np.random.default_rng(5)
    q = rng.integers(1, 2**24, 4096) / 2**24
    built = jax_ppf.static_cdf_table(name, *args, **kwargs)
    hits = np.zeros(0) if built is None else np.asarray(built[0], dtype)
    ends = np.array([2.0**-24, 1 - 2.0**-24])
    return np.concatenate([q, hits, ends]).astype(dtype)


@pytest.mark.parametrize("case", TABLE_FAMILIES, ids=_ids(TABLE_FAMILIES))
def test_table_tier_matches_jax(case, dtype):
    name, args, kwargs = case
    q = _table_quantiles(name, args, kwargs, dtype)
    ref = np.asarray(jax_ppf.call(name, jnp.asarray(q), *args, **kwargs))
    got = ppf.call(name, torch.from_numpy(q), *args, **kwargs).numpy()
    assert got.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, ref)


def test_boundary_equal_quantiles_take_the_lower_value():
    # scipy's convention: ppf(cdf(k)) = k, searchsorted side "left".
    table = scipy.stats.poisson(3.5).cdf(np.arange(6)).astype(np.float32)
    got = ppf.call("poisson", torch.from_numpy(table), 3.5)
    np.testing.assert_array_equal(got.numpy(), np.arange(6, dtype=np.float32))


@pytest.mark.parametrize("name,args", [("poisson", (2.7,)), ("binom", (9, 0.35))])
def test_discrete_traced_params_match_table_path(name, args):
    q = np.linspace(0.01, 0.99, 200).astype(np.float32)
    static = ppf.call(name, torch.from_numpy(q), *args)
    traced = ppf.call(name, torch.from_numpy(q), *(torch.full(q.shape, float(a)) for a in args))
    np.testing.assert_array_equal(static.numpy(), traced.numpy())
    ref = jax_ppf.call(name, jnp.asarray(q), *(jnp.full(q.shape, a, jnp.float32) for a in args))
    np.testing.assert_array_equal(traced.numpy(), np.asarray(ref))


def test_nbinom_bisection_matches_jax():
    q = np.random.default_rng(8).uniform(0.01, 0.99, 500).astype(np.float32)
    n, p = np.full(q.shape, 5.0, np.float32), np.full(q.shape, 0.5, np.float32)
    got = ppf.call("nbinom", torch.from_numpy(q), torch.from_numpy(n), torch.from_numpy(p))
    ref = jax_ppf.call("nbinom", jnp.asarray(q), jnp.asarray(n), jnp.asarray(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bisection_stops_at_its_trip_cap():
    # Width-only termination would spin where the float32 midpoint rounds
    # back onto lo; the cap returns hi, whose cdf is >= q.
    calls = []

    def cdf(k):
        calls.append(1)
        return torch.clamp(k / 1e9, max=1.0)

    k = special.discrete_ppf_bisect(cdf, torch.tensor([0.5]), torch.tensor([1e9]))
    assert len(calls) == 40 and cdf(k) >= 0.5


def test_gammaincc_is_batch_independent():
    a = torch.linspace(0.5, 30.0, 257)
    x = torch.linspace(0.1, 40.0, 257)
    whole = special.gammaincc(a, x)
    parts = torch.cat([special.gammaincc(a[i : i + 1], x[i : i + 1]) for i in range(257)])
    assert torch.equal(whole, parts)
    np.testing.assert_allclose(whole.double().numpy(), scipy.special.gammaincc(a.double().numpy(), x.double().numpy()),
                               rtol=1e-5, atol=1e-7)


def test_bird_survival_matches_jax():
    ref = jax_benchmarks.bird_survival()
    port = interop.from_reference(ref)[ref._id]
    q = np.random.default_rng(6).integers(1, 2**23, (8192, 2)) / 2**23
    a = np.asarray(ref.sample_from_quantiles(q))
    b = port.sample_from_quantiles(q).numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    assert abs(b.mean() - 1.2) < 0.1


# |port - JAX| over (the table's scale + the distance from its centre): the
# asinh-compressed variable's resolution.  ndtri_fast_wide's logs round up
# to 3 ulps apart in the two packages; measured at most 9.9e-7 (landau).
PCHIP_TOL = 4e-6
PCHIP_CHEAP = [c for c in PCHIP_FAMILIES if c[0] in
               ("rice", "skewnorm", "nct", "landau")]


@pytest.mark.parametrize("case", PCHIP_CHEAP, ids=_ids(PCHIP_CHEAP))
def test_pchip_tier_matches_jax(case):
    name, args, _ = case
    ref_table = jax_ppf.static_quantile_table(name, *args)
    table = ppf.static_quantile_table(name, *args)
    assert ppf.static_quantile_table(name, *args) is table  # cached
    np.testing.assert_array_equal(table[0], ref_table[0])
    assert table[1:] == ref_table[1:]
    q = np.random.default_rng(7).integers(1, 2**24, 4096).astype(np.float32) / 2**24
    ref = np.asarray(jax_ppf.call(name, jnp.asarray(q), *args))
    got = ppf.call(name, torch.from_numpy(q), *args).numpy()
    _, _, _, m, s = table
    assert (np.abs(got - ref) / (s + np.abs(ref - m))).max() <= PCHIP_TOL
    # Against scipy, as the JAX package holds its own tier (scaled error).
    exact = getattr(scipy.stats, name)(*args).ppf(q.astype(np.float64))
    scale = np.subtract(*np.percentile(exact, [75, 25]))
    assert np.abs(got - exact).max() / scale <= case[2] * 10


def test_scipy_callback_matches_scipy():
    # No function and a tensor parameter: scipy on the host, in float64.
    q = np.random.default_rng(9).uniform(0.001, 0.999, 300).astype(np.float32)
    a = np.linspace(-3.0, 3.0, 300).astype(np.float32)
    got = ppf.call("skewnorm", torch.from_numpy(q), torch.from_numpy(a))
    want = scipy.stats.skewnorm(a).ppf(q.astype(np.float64)).astype(np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jax_ppf.call("skewnorm", jnp.asarray(q), jnp.asarray(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # A discrete family whose parameters are tensors goes there too.
    m = torch.full((300,), 25.0)
    got = ppf.call("hypergeom", torch.from_numpy(q), 30, m, 20)
    np.testing.assert_array_equal(
        got.numpy(), scipy.stats.hypergeom(30, 25, 20).ppf(q.astype(np.float64)).astype(np.float32))


def test_multivariate_names_fail_inside_scipy_in_both_packages():
    assert ppf.is_multivariate("multivariate_normal") and not ppf.is_multivariate("norm")
    q = np.full(4, 0.5, np.float32)
    with pytest.raises(Exception, match="no attribute 'ppf'"):  # inside the callback
        jax_ppf.call("multivariate_normal", jnp.asarray(q), mean=[0.0, 0.0])
    with pytest.raises(AttributeError, match="no attribute 'ppf'"):
        ppf.call("multivariate_normal", torch.from_numpy(q), mean=[0.0, 0.0])
