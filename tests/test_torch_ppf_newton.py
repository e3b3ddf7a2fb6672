"""The port's Newton-tier ppf families against the JAX package and scipy.

The incomplete gamma/beta tier (``special.gammaincinv``/``betaincinv``)
and the safeguarded-Newton tier (``special.continuous_ppf_newton``), at
the parameters of the JAX package's family sweep
(``tests/test_distributions.py``).  Tolerances:

* float32 against the JAX package (under ``jax.jit``), q in
  [0.001, 0.999]: 1e-4 of the largest JAX value.  The two packages solve
  to the same tolerances on different incomplete functions
  (``torch.special.gammainc`` and the port's continued-fraction
  ``betainc`` against ``jax.scipy.special``'s): measured at most 5.6e-5
  (rdist), 3.8e-5 (t, df = 7);
* the same under both packages' ``kernel_safe_special`` for the 15
  families the megakernel takes (``test_torch_family_kernel.py``);
* float64 against ``scipy.stats``: 1e-6 of the largest value (measured at
  most 4.1e-9, t), 3e-5 for foldcauchy (its tail series, switched in at
  q > 0.99, truncates at < 3e-5 by design);
* batch independence: the ppf of a vector equals, bitwise, the ppfs of
  its slices, in float32 and float64;
* the incomplete-beta families near their median, on 4,001 uniforms in
  [0.499, 0.501] (``BAND``), against the JAX package within ``REL_TOL`` of
  the largest JAX value on ``Q``: the plain ``betainc`` clamps x at the
  last float below 1, as ``jax.scipy.special.betainc`` has no ceiling,
  so the float32 t ppf is 0 on as many of those points as the JAX
  package's (before, at the kernel's 1 - 1e-7, on 1.4-1.7x as many).
  The kernel transcription keeps the kernel's ceiling, and parts from the
  plain path there as the JAX package's kernel does.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import jax.scipy.special
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu.ops import special as jax_special
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.ops import ppf, special
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


REL_TOL = 1e-4
F64_TOL = 1e-6
F64_FAMILY_TOL = {"foldcauchy": 3e-5}
Q = np.linspace(0.001, 0.999, 2001).astype(np.float32)
BAND = np.linspace(0.499, 0.501, 4001).astype(np.float32)
MEDIAN = np.concatenate([BAND, Q[np.abs(Q - 0.5) <= 1e-3]])
# Zeros of the float32 t ppf on BAND, the JAX package's plain path (jax.jit).
T_MEDIAN_ZEROS = {2.0: 289, 4.0: 533, 7.0: 795, 10.0: 1001, 30.0: 1917, 100.0: 3687}

# (family, args, kwargs): tests/test_distributions.py's sweep.
NEWTON = [
    ("gamma", (2.5,), {"scale": 1.5}),
    ("erlang", (3,), {}),
    ("chi2", (5.0,), {}),
    ("chi", (3.0,), {}),
    ("maxwell", (), {}),
    ("invgamma", (3.0,), {}),
    ("nakagami", (2.0,), {}),
    ("beta", (2.0, 3.0), {}),
    ("betaprime", (3.0, 4.0), {}),
    ("t", (7.0,), {}),
    ("f", (5.0, 9.0), {}),
    ("dgamma", (2.5,), {}),
    ("gengamma", (3.0, 1.5), {}),
    ("gengamma", (3.0, -1.5), {}),
    ("gennorm", (1.5,), {}),
    ("halfgennorm", (1.3,), {}),
    ("loggamma", (2.0,), {}),
    ("pearson3", (0.8,), {}),
    ("pearson3", (-0.8,), {}),
    ("rdist", (3.0,), {}),
    ("argus", (2.0,), {}),
    ("argus", (0.5,), {}),
    ("argus", (5.0,), {}),
]
SAFEGUARDED = [
    ("semicircular", (), {}),
    ("invgauss", (1.5,), {"scale": 2.0}),
    ("wald", (), {}),
    ("cosine", (), {}),
    ("foldnorm", (1.8,), {}),
    ("foldcauchy", (1.5,), {}),
    ("exponnorm", (1.5,), {}),
    ("exponnorm", (0.05,), {}),
    ("recipinvgauss", (0.8,), {}),
    ("recipinvgauss", (3.0,), {}),
    ("genexpon", (1.5, 2.0, 1.0), {}),
    ("genexpon", (0.5, 0.3, 2.5), {}),
    ("kstwobign", (), {}),
    ("rel_breitwigner", (2.0,), {}),
    ("rel_breitwigner", (36.5,), {}),
]


def _id(case):
    name, args, _ = case
    return name + "".join(f"-{a:g}" for a in args)


def _jax(name, args, kwargs, q):
    return np.asarray(jax.jit(lambda q: jax_ppf.call(name, q, *args, **kwargs))(jnp.asarray(q)))


@pytest.mark.parametrize("case", NEWTON + SAFEGUARDED, ids=_id)
def test_newton_family_matches_jax(case):
    name, args, kwargs = case
    ref = _jax(name, args, kwargs, Q)
    got = ppf.call(name, torch.from_numpy(Q), *args, **kwargs).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("case", NEWTON + SAFEGUARDED, ids=_id)
def test_float64_matches_scipy(case):
    name, args, kwargs = case
    q = np.linspace(0.001, 0.999, 501)
    config.set_dtype(torch.float64)
    try:
        got = ppf.call(name, torch.from_numpy(q), *args, **kwargs).numpy()
    finally:
        config.set_dtype(torch.float32)
    assert got.dtype == np.float64
    ref = getattr(scipy.stats, name)(*args, **kwargs).ppf(q)
    assert np.abs(got - ref).max() <= F64_FAMILY_TOL.get(name, F64_TOL) * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", NEWTON + SAFEGUARDED, ids=_id)
def test_ppf_is_batch_independent(case, dtype):
    """A lane's trips and value are its own: the ppf of a vector equals,
    bitwise, the ppfs of its slices (ragged, and single elements)."""
    name, args, kwargs = case
    q = cuda_exec.philox_uniforms((11, 13), 300, 1)[:, 0].to(dtype)
    config.set_dtype(dtype)
    try:
        whole = ppf.call(name, q, *args, **kwargs)
        parts = torch.cat(
            [ppf.call(name, q[i:i + 37], *args, **kwargs) for i in range(0, 296, 37)]
            + [ppf.call(name, q[i:i + 1], *args, **kwargs) for i in range(296, 300)]
        )
    finally:
        config.set_dtype(torch.float32)
    assert whole.dtype == dtype
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


def test_newton_inverses_freeze_each_lane():
    """Batch independence holds for the inverses themselves, under both
    modes, and a lane's trips do not depend on its neighbours."""
    q = cuda_exec.philox_uniforms((3, 4), 64, 1)[:, 0]
    for mode in (special.kernel_safe_special, contextlib.nullcontext):
        with mode():
            a, b = torch.tensor(2.5), torch.tensor(0.5)
            x, trips = special.newton_gammaincinv(a, q)
            y, btrips = special.newton_betaincinv(a, b, q)
            singles = [special.newton_gammaincinv(a, q[i:i + 1]) for i in range(64)]
            bsingles = [special.newton_betaincinv(a, b, q[i:i + 1]) for i in range(64)]
        torch.testing.assert_close(torch.cat([s[0] for s in singles]), x, rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([s[0] for s in bsingles]), y, rtol=0, atol=0)
        assert trips == sum(s[1] for s in singles) and btrips == sum(s[1] for s in bsingles)
        assert 64 <= trips <= 26 * 64 and 64 <= btrips <= 40 * 64


def test_gammainc_plain_path_is_the_torch_function():
    a = torch.tensor([0.5, 2.5, 30.0])
    x = torch.tensor([0.3, 2.0, 25.0])
    torch.testing.assert_close(special._gammainc_torch(a, x), torch.special.gammainc(a, x))
    # The kernel's series and continued fraction agree with it to float32.
    torch.testing.assert_close(special.gammainc_kernel(a, x), torch.special.gammainc(a, x),
                               rtol=2e-6, atol=2e-7)


def test_betainc_matches_scipy():
    from scipy.special import betainc as sp_betainc

    a = np.array([0.5, 2.0, 3.5, 30.0, 1.0])
    b = np.array([0.5, 3.0, 0.5, 20.0, 7.0])
    x = np.array([0.3, 0.6, 0.9, 0.55, 0.05])
    ref = sp_betainc(a, b, x)
    got64 = special.betainc(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x))
    np.testing.assert_allclose(got64.numpy(), ref, rtol=1e-12, atol=1e-14)
    got32 = special.betainc(*(torch.from_numpy(v).float() for v in (a, b, x)))
    np.testing.assert_allclose(got32.numpy(), ref, rtol=2e-5, atol=2e-6)
    kernel32 = special.betainc_kernel(*(torch.from_numpy(v).float() for v in (a, b, x)))
    np.testing.assert_allclose(kernel32.numpy(), ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name,args", [
    ("poisson", (3.5,)), ("binom", (12, 0.4)), ("nbinom", (5, 0.5)), ("skewnorm", (2.0,)),
])
def test_table_tier_and_unregistered_families_name_a8(name, args):
    # Ported since: the CDF-table tier (exact) and the PCHIP tier (within
    # the tolerance test_torch_ppf_tables.py states).  What still names A8
    # is a multivariate node.
    got = ppf.call(name, torch.from_numpy(Q), *args).numpy()
    ref = np.asarray(jax_ppf.call(name, jnp.asarray(Q), *args))
    if name == "skewnorm":
        np.testing.assert_allclose(got, ref, rtol=4e-6, atol=4e-6)
    else:
        np.testing.assert_array_equal(got, ref)
    # A multivariate node samples now (ops/multivariate.py), (n, d) as in
    # the JAX package.
    mvn = Distribution("multivariate_normal", mean=[0, 0]).sample(4, random_state=0)
    assert mvn.shape == (4, 2) and bool(torch.isfinite(mvn).all())


@functools.lru_cache
def _jax_median(name, args):
    """(JAX on MEDIAN, largest |JAX| on Q): one jit."""
    ref = _jax(name, args, {}, np.concatenate([MEDIAN, Q]))
    return ref[:MEDIAN.size], np.abs(ref[MEDIAN.size:]).max()


def _on_band_and_q(name, args):
    """(port on MEDIAN, JAX on MEDIAN, largest |JAX| on Q)."""
    got = ppf.call(name, torch.from_numpy(MEDIAN), *args).numpy()
    return (got, *_jax_median(name, args))


@pytest.mark.parametrize("df", list(T_MEDIAN_ZEROS), ids=lambda df: f"{df:g}")
def test_t_near_the_median_matches_jax(df):
    got, ref, top = _on_band_and_q("t", (df,))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= REL_TOL * top
    zeros = int((got[:BAND.size] == 0.0).sum())
    assert zeros == int((ref[:BAND.size] == 0.0).sum()) == T_MEDIAN_ZEROS[df]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_plain_betainc_ceiling_is_the_last_float_below_one(dtype):
    x = torch.tensor(1.0 - torch.finfo(dtype).eps / 2.0, dtype=dtype)
    assert x == torch.nextafter(torch.ones((), dtype=dtype), torch.zeros((), dtype=dtype))
    a, b = torch.tensor(15.0, dtype=dtype), torch.tensor(0.5, dtype=dtype)
    got = special.betainc(a, b, x).item()
    assert got < 1.0
    assert abs(got - scipy.special.betainc(15.0, 0.5, x.item())) <= (
        1e-6 if dtype == torch.float32 else 1e-12)
    if dtype == torch.float32:
        ref = float(jax.scipy.special.betainc(jnp.float32(15.0), jnp.float32(0.5),
                                              jnp.float32(x.item())))
        assert abs(got - ref) <= 1e-6
        # The kernel clamps at 1 - 1e-7 (1 - 2^-23 in float32): 1 - 0.0014964.
        assert abs(got - special.betainc_kernel(a, b, x).item()) > 4e-4


def test_betainc_kernel_keeps_the_kernel_ceiling():
    x = np.array([1.0 - 2.0**-24, 1.0 - 2.0**-23], np.float32)
    got = special.betainc_kernel(torch.tensor(15.0), torch.tensor(0.5), torch.from_numpy(x))
    ref = jax.jit(jax_special.betainc_kernel)(jnp.float32(15.0), jnp.float32(0.5), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0] == got[1]  # both at the ceiling


@pytest.mark.parametrize("name,args", [
    ("beta", (2.0, 3.0)), ("beta", (30.0, 30.0)),
    ("betaprime", (3.0, 4.0)), ("betaprime", (50.0, 50.0)),
    ("f", (5.0, 9.0)), ("f", (100.0, 100.0)),
    ("rdist", (3.0,)), ("rdist", (40.0,)),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{a:g}" for a in v))
def test_incomplete_beta_families_match_jax_near_the_median(name, args):
    got, ref, top = _on_band_and_q(name, args)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= REL_TOL * top


def test_t_node_matches_jax_through_sample_from_quantiles():
    ref = JaxDistribution("t", df=30.0) + 1.0
    port = interop.from_reference(ref)[ref._id]
    q = BAND[:, None]
    expected = np.asarray(ref.sample_from_quantiles(q))
    got = port.sample_from_quantiles(q).numpy()
    top = _jax_median("t", (30.0,))[1]
    assert got.shape == expected.shape == (BAND.size,) and np.isfinite(got).all()
    assert np.abs(got - expected).max() <= REL_TOL * top


def test_kernel_and_plain_t_part_near_the_median_as_in_the_jax_package():
    """Near its median the kernel's t ppf (betainc at the 1 - 1e-7
    ceiling) is 0 on more points than the plain path's, in both packages:
    the port's twin, which runs the kernel's tape, counts the JAX
    package's kernel-mode zeros, and its plain path the plain ones."""
    node = Distribution("t", df=30.0)
    plan = tcompile.get_plan(node + 1.0)
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, {node._id}))
    twin = cuda_exec.run_tape(tape, torch.from_numpy(BAND)[:, None])[0]
    plain = ppf.call("t", torch.from_numpy(BAND), 30.0)
    with jax_special.kernel_safe_special():
        jax_kernel = _jax("t", (30.0,), {}, BAND)
    jax_plain = _jax_median("t", (30.0,))[0][:BAND.size]
    assert int((twin == 0.0).sum()) == int((jax_kernel == 0.0).sum()) == 2793
    assert int((plain == 0.0).sum()) == int((jax_plain == 0.0).sum()) == T_MEDIAN_ZEROS[30.0]
