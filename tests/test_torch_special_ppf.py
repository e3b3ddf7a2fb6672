"""The port's special functions and ppf families against the JAX package.

Both run the same float32 quantile grid.  The JAX side runs under
``jax.jit``, as its sampling programs do.  Tolerances:

* q in [0.01, 0.99]: at most 4 float32 ulps of the JAX value;
* the tails, on the float32 grid the engine's generators draw from
  (multiples of 2^-23, clamped to [2^-24, 1 - 2^-24]) and on arbitrary
  quantiles down to 1e-5: 1e-3 absolute on the standard score (measured
  3.0e-4).  Below 1e-5, off that grid, the two drift apart because
  PyTorch rounds 2q - 1 to float32 and XLA's fused CPU code does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu.ops import qmc as jax_qmc
from probabilit_tpu.ops import special as jax_special
from probabilit_tpu_torch.ops import ppf, qmc, special

ULP_TOL = 4
TAIL_ABS_TOL = 1e-3  # on the standard score

_K = np.unique(np.round(np.logspace(0, 16.5, 200, base=2)))


def _grid():
    generator_grid = np.concatenate(
        [[2.0**-24], _K * 2.0**-23, 1.0 - _K * 2.0**-23, [1.0 - 2.0**-24]]
    )
    arbitrary_tails = np.concatenate(
        [np.logspace(-5, -2, 300), 1.0 - np.logspace(-5, -2, 300)]
    )
    central = np.linspace(0.01, 0.99, 2001)
    return np.concatenate([generator_grid, arbitrary_tails, central]).astype(np.float32)


Q = _grid()
CENTRAL = (Q >= 0.01) & (Q <= 0.99)


def _ulps(ref, got):
    ref = np.asarray(ref, np.float32)
    return np.abs(ref.astype(np.float64) - got) / np.spacing(np.abs(ref))


def test_grid_holds_the_clamp_endpoints():
    assert np.float32(2.0**-24) in Q and np.float32(1.0 - 2.0**-24) in Q


def test_ndtri_fast_matches_jax():
    ref = np.asarray(jax.jit(jax_special.ndtri_fast)(jnp.asarray(Q)))
    got = special.ndtri_fast(torch.from_numpy(Q)).numpy()
    assert got.dtype == np.float32
    assert _ulps(ref, got)[CENTRAL].max() <= ULP_TOL
    assert np.abs(ref - got)[~CENTRAL].max() <= TAIL_ABS_TOL


def test_ndtri_fast_float64_is_exact_ndtri():
    q = torch.tensor([1e-12, 0.025, 0.5, 0.975], dtype=torch.float64)
    # The JAX package takes jax.scipy.special.ndtri here, in float64 mode;
    # scipy's ndtri is the same function.
    np.testing.assert_allclose(
        special.ndtri_fast(q).numpy(), scipy.special.ndtri(q.numpy()), rtol=1e-13
    )


def test_erfinv_saturates_with_sign():
    x = torch.tensor([-1.0, 1.0], dtype=torch.float32)
    got = special.erfinv_f32(x).numpy()
    ref = np.asarray(jax_special.erfinv_f32(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(np.sign(got), [-1.0, 1.0])
    np.testing.assert_allclose(got, ref, rtol=4 * 2.0**-23)


FAMILIES = [
    ("uniform", dict(loc=20.0, scale=15.0)),
    ("norm", dict(loc=5000.0, scale=400.0)),
    ("expon", dict(scale=0.1)),
    ("lognorm", dict(s=0.25, scale=50.0)),
    ("triang", dict(c=0.4, loc=800.0, scale=600.0)),
]


def _score_slope(name, params, value):
    """d value / d z: puts a tail error on the standard-score scale."""
    if name == "lognorm":
        return params["s"] * np.abs(value)  # loc = 0
    return params.get("scale", 1.0)


@pytest.mark.parametrize("name,params", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_ppf_family_matches_jax(name, params):
    ref = np.asarray(
        jax.jit(lambda q: jax_ppf.call(name, q, **params))(jnp.asarray(Q))
    )
    got = ppf.call(name, torch.from_numpy(Q), **params).numpy()
    assert got.dtype == np.float32
    assert _ulps(ref, got)[CENTRAL].max() <= ULP_TOL
    score_err = np.abs(ref - got) / _score_slope(name, params, ref)
    assert score_err[~CENTRAL].max() <= TAIL_ABS_TOL


def test_ppf_takes_tensor_parameters():
    q = torch.from_numpy(Q[CENTRAL][:64])
    loc = torch.linspace(-1.0, 1.0, 64)
    got = ppf.call("norm", q, loc=loc, scale=2.0)
    ref = np.asarray(jax_ppf.call("norm", jnp.asarray(q.numpy()), loc=jnp.asarray(loc.numpy()), scale=2.0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_unported_family_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="A8"):
        ppf.call("gamma", torch.full((4,), 0.5), a=2.0)


def test_clamp_open_unit_matches_jax():
    q = np.array([0.0, 1e-30, 0.5, 1.0], np.float32)
    ref = np.asarray(jax_qmc.clamp_open_unit(jnp.asarray(q)))
    np.testing.assert_array_equal(qmc.clamp_open_unit(torch.from_numpy(q)).numpy(), ref)
    np.testing.assert_array_equal(ref, [2.0**-24, 2.0**-24, 0.5, 1.0 - 2.0**-24])


def test_clamp_open_unit_float64_uses_the_53_bit_grid():
    q = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
    tiny = 2.0**-53
    np.testing.assert_array_equal(qmc.clamp_open_unit(q).numpy(), [tiny, 0.5, 1.0 - tiny])
