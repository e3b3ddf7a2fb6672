"""The port's QMC generators (``probabilit_tpu_torch/ops/qmc.py`` and
``ops/hashing.py``) against the JAX package's, on the CPU.

Each generator takes its randomisation as an argument, so the JAX
package's own values (its Owen seeds, Halton shift and LHS round keys,
drawn from jax keys) go in and the points are compared bitwise: the
direction numbers (the port's native search and its Python twin), Sobol
unscrambled and scrambled across the 2^31 and 2^32 index boundaries,
Halton unscrambled and shifted (float32 bitwise; float64 within
4 * 2^-53, XLA fusing multiply-adds the port rounds apart), LHS at awkward
totals and with padding lanes, and the mixers.  Then the ports of the
JAX package's ``tests/test_qmc.py`` without its mesh cases (ROADMAP A12),
run through the port's generators, ``sample`` and ``ops/orderstats``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from probabilit_tpu.ops import hashing as jax_hashing
from probabilit_tpu.ops import qmc as jax_qmc
from probabilit_tpu_torch import _build, config
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.ops import hashing, qmc
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


def _owen_seeds(key, d):
    """The JAX package's Sobol scramble seeds (``qmc._sobol_traced``)."""
    seeds = jax.random.randint(key, (d,), 0, np.iinfo(np.int32).max, dtype=jnp.int32)
    return np.asarray(seeds.astype(jnp.uint32))


def _round_keys(key, d):
    """The JAX package's LHS round and jitter keys (``_latin_hypercube_traced``)."""
    return np.asarray(jax.random.bits(key, (d, qmc._FEISTEL_ROUNDS + 1), dtype=jnp.uint32))


def _words(x):
    """uint32 values as the port's int32 words."""
    return torch.from_numpy(np.asarray(x, np.uint32).view(np.int32).copy())


def _uint32(words):
    return words.numpy().view(np.uint32)


# --- Bitwise against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 7, 64, 1000])
def test_direction_numbers_native_and_twin_match_jax(d):
    ref = jax_qmc._direction_numbers_np(d)
    np.testing.assert_array_equal(qmc._direction_numbers_np(d), ref)
    np.testing.assert_array_equal(qmc._direction_numbers_py(d), ref)


def test_native_search_is_built_into_build_dir():
    path, _ = _build.build_host("sobol")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("sobol-") and path.exists()


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback to the Python search: a broken source raises."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "sobol.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed with exit code"):
        _build.build_host("sobol")

    def broken(name):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(_build, "load_host", broken)
    with pytest.raises(RuntimeError, match="no compiler"):
        qmc._native_directions(3)


def test_mixers_match_jax():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    k = np.uint32(0xDEADBEEF)
    np.testing.assert_array_equal(
        _uint32(hashing.fmix32(_words(x))), np.asarray(jax_hashing.fmix32(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _uint32(hashing.keyed_mix32(_words(x), int(k))),
        np.asarray(jax_hashing.keyed_mix32(jnp.asarray(x), k)))
    np.testing.assert_array_equal(
        _uint32(qmc._reverse_bits32(_words(x))), np.asarray(jax_qmc._reverse_bits32(jnp.asarray(x))))
    for seed in (0x12345678, 0xFEDCBA98):
        np.testing.assert_array_equal(
            _uint32(qmc._owen_scramble(_words(x), seed)),
            np.asarray(jax_qmc._owen_scramble(jnp.asarray(x), np.uint32(seed))))


@pytest.mark.parametrize("offset", [0, 2**31 - 5, 2**32 - 7])
def test_unscrambled_sobol_is_bitwise_jax(offset):
    key = jax.random.PRNGKey(0)
    for n, d in ((1000, 3), (257, 11)):
        ref = np.asarray(jax_qmc.sobol(key, n, d, scramble=False, offset=offset))
        got = qmc.sobol(None, n, d, scramble=False, offset=offset).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("offset", [0, 12345, 2**31 - 5, 2**32 - 7])
def test_scrambled_sobol_with_jax_owen_seeds_is_bitwise(offset):
    key = jax.random.PRNGKey(3)
    n, d = 777, 9
    ref = np.asarray(jax_qmc.sobol(key, n, d, offset=offset))
    got = qmc.sobol(_owen_seeds(key, d), n, d, offset=offset).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("offset", [0, 12345, 2**31 - 1000])
def test_halton_unscrambled_and_shifted_are_bitwise_jax(offset):
    key = jax.random.PRNGKey(11)
    for n, d in ((1000, 3), (300, 14)):
        ref = np.asarray(jax_qmc.halton(key, n, d, scramble=False, offset=offset))
        np.testing.assert_array_equal(qmc.halton(None, n, d, scramble=False, offset=offset).numpy(), ref)
        shift = np.asarray(jax.random.uniform(key, (d,), dtype=jnp.float32))
        ref = np.asarray(jax_qmc.halton(key, n, d, offset=offset))
        np.testing.assert_array_equal(qmc.halton(shift, n, d, offset=offset).numpy(), ref)


def test_halton_over_many_digits_is_bitwise_jax():
    """Every digit of 30 bases over 2e5 points: the fused sums hold."""
    key = jax.random.PRNGKey(2)
    n, d = 200_000, 30
    shift = np.asarray(jax.random.uniform(key, (d,), dtype=jnp.float32))
    np.testing.assert_array_equal(
        qmc.halton(shift, n, d, offset=7).numpy(), np.asarray(jax_qmc.halton(key, n, d, offset=7)))


def test_float64_points_match_jax():
    """Sobol and LHS bitwise; Halton within 4 * 2^-53 (2 ulps before the
    shift): XLA fuses its float64 multiply-adds, the port rounds them apart."""
    key = jax.random.PRNGKey(5)
    n, d = 4000, 10
    with jax.enable_x64(True):
        sob = np.asarray(jax_qmc.sobol(key, n, d, dtype=jnp.float64, offset=5))
        lhs = np.asarray(jax_qmc.latin_hypercube(key, n, d, dtype=jnp.float64, offset=7, total=9000))
        shift = np.asarray(jax.random.uniform(key, (d,), dtype=jnp.float64))
        hal = np.asarray(jax_qmc.halton(key, n, d, dtype=jnp.float64, offset=123))
        seeds, rk = _owen_seeds(key, d), _round_keys(key, d)
    np.testing.assert_array_equal(qmc.sobol(seeds, n, d, dtype=torch.float64, offset=5).numpy(), sob)
    np.testing.assert_array_equal(
        qmc.latin_hypercube(rk, n, d, dtype=torch.float64, offset=7, total=9000).numpy(), lhs)
    got = qmc.halton(shift, n, d, dtype=torch.float64, offset=123).numpy()
    np.testing.assert_allclose(got, hal, rtol=0, atol=4 * 2.0**-53)


@pytest.mark.parametrize(
    "total,n,offset",
    [(1000, 1024, 0), (100, 60, 40), (2**32, 64, 2**31), (4097, 4097, 0), (5, 5, 0),
     (1, 1, 0), (3, 8, 0), (65, 64, 1), (1 << 20, 3000, (1 << 20) - 1000)],
)
def test_lhs_with_jax_round_keys_is_bitwise(total, n, offset):
    key = jax.random.PRNGKey(total % 1000)
    d = 3
    ref = np.asarray(jax_qmc.latin_hypercube(key, n, d, offset=offset, total=total))
    got = qmc.latin_hypercube(_round_keys(key, d), n, d, offset=offset, total=total).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("total", [2, 3, 63, 1000, 4097])
def test_feistel_permutation_matches_jax(total):
    rk = np.asarray(jax.random.bits(jax.random.PRNGKey(total), (4,), dtype=jnp.uint32))
    idx = np.arange(total + 40, dtype=np.uint32)  # the tail: padding lanes
    ref = np.asarray(jax_qmc._feistel_permutation(jnp.asarray(idx), jnp.asarray(rk), total))
    np.testing.assert_array_equal(_uint32(qmc._feistel_permutation(_words(idx), rk, total)), ref)


def test_clamps_match_jax():
    q = np.array([0.0, 1e-40, 1e-30, 0.5, 1.0], np.float32)
    np.testing.assert_array_equal(
        qmc.clamp_open_unit_wide(torch.from_numpy(q)).numpy(),
        np.asarray(jax_qmc.clamp_open_unit_wide(jnp.asarray(q))))
    q64 = torch.tensor([0.0, 1e-310, 0.5, 1.0], dtype=torch.float64)
    np.testing.assert_array_equal(
        qmc.clamp_open_unit_wide(q64).numpy(), [1e-300, 1e-300, 0.5, 1.0 - 2.0**-53])


def test_generate_derives_each_randomisation_from_the_seed():
    """The randomisation is a function of (method, seed): the same call
    repeats, another seed or method draws another one."""
    for m in ("sobol", "halton", "lhs", "antithetic"):
        a = qmc.generate(m, 1, 64, 3)
        np.testing.assert_array_equal(a.numpy(), qmc.generate(m, 1, 64, 3).numpy())
        assert not torch.equal(a, qmc.generate(m, 2, 64, 3))
    r = qmc.randomisation("sobol", 1, 4)
    assert r.shape == (4,) and (r < 2**31).all()
    assert qmc.randomisation("lhs", 1, 4).shape == (4, 5)
    assert qmc.randomisation("halton", 1, 4, torch.float32).dtype == np.float32
    with pytest.raises(KeyError, match="Unknown sampling method"):
        qmc.generate("bogus", 0, 4, 2)
    with pytest.raises(ValueError, match="offset requires"):
        qmc.generate(None, 0, 4, 2, offset=3)


@pytest.mark.parametrize("method", ["sobol", "halton", "lhs", "antithetic"])
def test_generate_blocks_across_the_index_boundaries_are_slices(method):
    """Two blocks equal one call, across the top of the index range (2^32
    wraps; Halton's float32 indices stop below 2^31; LHS at a partial
    stratification with padding rows)."""
    base = {"sobol": 2**32 - 500, "halton": 2**31 - 1200, "lhs": 4500, "antithetic": 2**32 - 501}
    start, total = base[method], 5000
    full = qmc.generate(method, 4, 1000, 5, offset=start, total=total)
    lo = qmc.generate(method, 4, 333, 5, offset=start, total=total)
    hi = qmc.generate(method, 4, 667, 5, offset=(start + 333) % 2**32, total=total)
    np.testing.assert_array_equal(full.numpy(), torch.cat([lo, hi]).numpy())


# --- Ports of tests/test_qmc.py --------------------------------------------------------


def _lhs(seed, n, d, **kw):
    return qmc.latin_hypercube(qmc.randomisation("lhs", seed, d), n, d, **kw).numpy()


def _sobol(seed, n, d, **kw):
    return qmc.sobol(qmc.randomisation("sobol", seed, d), n, d, **kw).numpy()


def test_lhs_stratification():
    n, d = 64, 5
    pts = _lhs(0, n, d)
    assert pts.shape == (n, d)
    for j in range(d):
        assert sorted(np.floor(pts[:, j] * n).astype(int).tolist()) == list(range(n))


def test_lhs_range():
    pts = _lhs(1, 100, 3)
    assert pts.min() >= 0.0 and pts.max() < 1.0


@pytest.mark.parametrize("n", [1, 2, 3, 63, 64, 65, 1000, 4097])
def test_feistel_bijective_at_awkward_sizes(n):
    rk = qmc.randomisation("lhs", n, 1)[0]
    out = qmc._feistel_permutation(torch.arange(n, dtype=torch.int32), rk, n).numpy()
    assert sorted(out.tolist()) == list(range(n))


def test_lhs_offset_blocks_are_slices():
    full = _lhs(2, 100, 3)
    lo = _lhs(2, 40, 3, offset=0, total=100)
    hi = _lhs(2, 60, 3, offset=40, total=100)
    np.testing.assert_array_equal(full, np.vstack([lo, hi]))


def test_lhs_full_uint32_domain_boundary():
    rk = qmc.randomisation("lhs", 0, 1)[0]
    idx = _words([0, 1, 2**31, 2**32 - 1])
    out = _uint32(qmc._feistel_permutation(idx, rk, 1 << 32))
    assert len(set(out.tolist())) == 4
    with pytest.raises(ValueError, match="2\\^32"):
        qmc._feistel_permutation(idx, rk, (1 << 32) + 1)
    pts = _lhs(1, 64, 2, offset=2**31, total=1 << 32)
    assert pts.shape == (64, 2) and 0.0 < pts.min() and pts.max() < 1.0


def test_lhs_out_of_domain_padding_rows_terminate():
    for seed in range(8):  # some keys put padding lanes on cycles outside [0, total)
        pts = _lhs(seed, 1024, 1, total=1000)
        assert pts.shape == (1024, 1) and np.all((0 < pts) & (pts < 1))
        assert sorted(np.floor(pts[:1000, 0] * 1000).astype(int).tolist()) == list(range(1000))


def test_lhs_different_seeds_differ():
    assert not np.allclose(_lhs(0, 64, 2), _lhs(9, 64, 2))


def test_lhs_jitter_uniform_within_strata():
    n = 4096
    frac = (_lhs(4, n, 1)[:, 0].astype(np.float64) * n) % 1.0
    assert scipy.stats.kstest(frac, "uniform").pvalue > 0.01


def test_sobol_range_and_shape():
    pts = _sobol(0, 256, 10)
    assert pts.shape == (256, 10) and pts.min() >= 0.0 and pts.max() < 1.0


def test_unscrambled_first_dim_is_van_der_corput():
    pts = qmc.sobol(None, 8, 1, scramble=False).numpy()
    expected = np.array([0.0, 0.5, 0.75, 0.25, 0.375, 0.875, 0.625, 0.125])
    np.testing.assert_allclose(pts[:, 0], expected, atol=1e-6)


def test_sobol_equidistribution_base2():
    n = 128
    pts = _sobol(3, n, 8)
    for j in range(8):
        counts = np.bincount(np.floor(pts[:, j] * 16).astype(int), minlength=16)
        np.testing.assert_array_equal(counts, n // 16)


def test_sobol_scrambling_randomises():
    assert not np.allclose(_sobol(0, 64, 4), _sobol(1, 64, 4))


def test_sobol_offset_blocks_are_disjoint_slices():
    full = _sobol(0, 64, 3)
    np.testing.assert_array_equal(full, np.vstack([_sobol(0, 32, 3), _sobol(0, 32, 3, offset=32)]))


def test_sobol_offset_above_int31_wraps_not_crashes():
    pts = _sobol(0, 8, 2, offset=2**31)
    assert pts.shape == (8, 2) and 0.0 <= pts.min() and pts.max() < 1.0
    np.testing.assert_array_equal(pts, qmc.generate("sobol", 0, 8, 2, offset=2**31).numpy())


def test_sobol_integration_beats_pseudo_random():
    n, d = 1024, 4
    sob = _sobol(0, n, d)
    mc = qmc.uniform(0, n, d).numpy()
    assert abs(np.prod(sob, axis=1).mean() - 1 / 16) < abs(np.prod(mc, axis=1).mean() - 1 / 16)


def test_halton_unscrambled_prefix():
    pts = qmc.halton(None, 4, 2, scramble=False).numpy()
    np.testing.assert_allclose(pts[:, 0], [0, 0.5, 0.25, 0.75], atol=1e-6)
    np.testing.assert_allclose(pts[:, 1], [0, 1 / 3, 2 / 3, 1 / 9], atol=1e-6)


def test_halton_scrambled_in_range():
    pts = qmc.generate("halton", 5, 200, 6).numpy()
    assert pts.min() >= 0.0 and pts.max() < 1.0
    assert np.allclose(pts.mean(axis=0), 0.5, atol=0.06)


def test_halton_offset_above_index_cap_raises():
    with pytest.raises(ValueError, match="int32-indexed"):
        qmc.generate("halton", 0, 8, 2, offset=2**31)


def test_antithetic_rows_pair_and_reflect():
    q = qmc.generate("antithetic", 0, 64, 4).numpy()
    assert q.shape == (64, 4) and q.min() > 0.0 and q.max() < 1.0
    np.testing.assert_allclose(q[1::2], 1.0 - q[0::2], atol=3e-7)


def test_antithetic_offset_blocks_are_slices():
    full = qmc.generate("antithetic", 3, 100, 3).numpy()
    a = qmc.generate("antithetic", 3, 37, 3).numpy()
    b = qmc.generate("antithetic", 3, 63, 3, offset=37).numpy()
    np.testing.assert_array_equal(full, np.vstack([a, b]))


def test_antithetic_column_means_exact():
    q = qmc.generate("antithetic", 7, 4096, 5).numpy()
    np.testing.assert_allclose(q.mean(axis=0), 0.5, atol=1e-6)
    q64 = qmc.generate("antithetic", 7, 4096, 3, dtype=torch.float64).numpy()
    np.testing.assert_allclose(q64[1::2], 1.0 - q64[0::2], atol=1e-15)


def test_antithetic_monotone_model_variance_collapse():
    model = Distribution("norm") + Distribution("uniform")
    s = model.sample(4096, random_state=11, method="antithetic").numpy()
    assert abs(s.mean() - 0.5) < 1e-4


def test_antithetic_different_seeds_differ():
    a = qmc.generate("antithetic", 0, 32, 2)
    assert not torch.equal(a, qmc.generate("antithetic", 1, 32, 2))


@pytest.mark.parametrize("method", ["lhs", "halton", "sobol", "antithetic"])
def test_sample_method_argument(method):
    s = Distribution("uniform").sample(128, random_state=0, method=method).numpy()
    assert s.shape == (128,)
    assert np.isclose(s.mean(), 0.5, atol=0.05)


def test_unknown_method_raises():
    with pytest.raises(KeyError):
        Distribution("uniform").sample(10, random_state=0, method="bogus")


def test_qmc_improves_mean_estimate():
    s = Distribution("uniform").sample(256, random_state=0, method="lhs").numpy()
    assert abs(s.mean() - 0.5) < 0.002


def test_sobol_matches_scipy_joe_kuo_integration_error():
    """The generated direction numbers with the Owen hash scramble reach
    the integration quality of scipy's Joe-Kuo Sobol."""
    import scipy.stats.qmc as sq

    d, n = 10, 4096
    errs_ours, errs_scipy = [], []
    for seed in range(10):
        ours = _sobol(seed, n, d).astype(np.float64)
        sp = sq.Sobol(d=d, seed=seed).random(n)
        f = lambda x: np.prod(2 * x, axis=1).mean()  # noqa: E731
        errs_ours.append((f(ours) - 1.0) ** 2)
        errs_scipy.append((f(sp) - 1.0) ** 2)
    assert np.sqrt(np.mean(errs_ours)) < 2.0 * np.sqrt(np.mean(errs_scipy))


def test_sorted_uniforms_sorted_and_uniform():
    from probabilit_tpu_torch.ops.orderstats import sorted_uniforms

    u = sorted_uniforms(torch.Generator().manual_seed(0), 3, 50_000).numpy()
    assert u.shape == (3, 50_000)
    assert (np.diff(u, axis=1) >= 0).all()
    assert u.min() > 0 and u.max() < 1
    # Each row is a sorted uniform sample: KS against the uniform CDF.
    for row in u:
        assert scipy.stats.kstest(row, "uniform").pvalue > 1e-3


def test_sorted_uniforms_exact_count_boundaries():
    from probabilit_tpu_torch.ops.orderstats import sorted_uniforms

    for n in [1, 2, 4095, 4096, 4097]:  # at and around the block size
        u = sorted_uniforms(torch.Generator().manual_seed(1), 1, n).numpy()
        assert u.shape == (1, n)
        assert (np.diff(u[0]) >= 0).all()
