"""The port's permutation correlator (``ops/permutation.py``) on the CPU.

``CorrelationMatrix`` (``delta_column``, ``update_column``, ``commit``)
and ``SwapIndexGenerator`` are host numpy in both packages and equal bit
for bit from the same numpy generator; ``subiters`` is equal over a grid
and the constructor's errors have the JAX package's texts.  The climb
runs on the device from a ``torch.Generator``, so it is held to the JAX
package's results, not its bits: on the JAX docstring's (100, 2) case it
reaches |corr - 0.7| < 0.1, and on a (2,000, 4) matrix, Pearson and
Spearman, with and without weights, an error no worse than the JAX
package's on the same X plus 0.01.  Every output column is a permutation
of its input.
"""

import numpy as np
import pytest
import scipy.stats as sps
import torch

from probabilit_tpu.ops import permutation as jax_permutation
from probabilit_tpu_torch import config
from probabilit_tpu_torch.ops import permutation
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

ERROR_SLACK = 0.01
TARGET4 = np.array([
    [1.0, 0.5, 0.3, 0.1],
    [0.5, 1.0, 0.2, 0.0],
    [0.3, 0.2, 1.0, -0.2],
    [0.1, 0.0, -0.2, 1.0],
])
WEIGHTS4 = np.array([
    [1.0, 4.0, 1.0, 1.0],
    [4.0, 1.0, 2.0, 1.0],
    [1.0, 2.0, 1.0, 1.0],
    [1.0, 1.0, 1.0, 1.0],
])


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.mark.parametrize("kind", ["pearson", "spearman"])
def test_correlation_matrix_is_the_jax_bookkeeping(kind):
    X = np.random.default_rng(3).normal(size=(40, 4))
    got, ref = (m.CorrelationMatrix(X, correlation_type=kind)
                for m in (permutation, jax_permutation))
    np.testing.assert_array_equal(got.corr_mat, ref.corr_mat)
    gen_got = permutation.SwapIndexGenerator(np.random.default_rng(8), 40)
    gen_ref = jax_permutation.SwapIndexGenerator(np.random.default_rng(8), 40)
    for step in range(30):
        (i, j), (ri, rj) = gen_got(1 + step % 5), gen_ref(1 + step % 5)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(j, rj)
        col = step % 4
        np.testing.assert_array_equal(got.delta_column(col, i, j), ref.delta_column(col, i, j))
        np.testing.assert_array_equal(got.update_column(col, i, j), ref.update_column(col, i, j))
        if step % 2 == 0:
            got.commit(col, i, j)
            ref.commit(col, i, j)
    for attr in ("corr_mat", "numerator", "X", "X_"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr))
    with pytest.raises(ValueError, match="disjoint"):
        got.delta_column(0, [1, 2], [2, 3])


def test_subiters_match_jax():
    for n in (1, 2, 10, 100, 1000, 10_000):
        for i in range(0, n + 1, max(1, n // 50)):
            assert permutation.PermutationCorrelator.subiters(n, i) == \
                jax_permutation.PermutationCorrelator.subiters(n, i)


@pytest.mark.parametrize("kwargs", [
    dict(weights=np.array([[1.0, 0.0], [0.0, 1.0]])), dict(iterations=-1),
    dict(iterations=1.5), dict(tol=0), dict(tol="a"), dict(seed=1.5), dict(verbose=1),
], ids=["weights", "negative", "float_iterations", "tol", "tol_type", "seed", "verbose"])
def test_constructor_errors_match_jax(kwargs):
    with pytest.raises((TypeError, ValueError)) as got:
        permutation.PermutationCorrelator(**kwargs)
    with pytest.raises((TypeError, ValueError)) as ref:
        jax_permutation.PermutationCorrelator(**kwargs)
    assert type(got.value) is type(ref.value) and str(got.value) == str(ref.value)


def test_docstring_case_reaches_the_target():
    X = np.random.default_rng(42).normal(size=(100, 2))
    pc = permutation.PermutationCorrelator(seed=0).set_target(np.array([[1, 0.7], [0.7, 1]]))
    Xt = pc(X).numpy()
    assert abs(np.corrcoef(Xt, rowvar=False)[0, 1] - 0.7) < 0.1


def _observed(Y, kind):
    if kind == "spearman":
        return sps.spearmanr(Y).statistic
    return np.corrcoef(Y, rowvar=False)


def _assert_permutations(X, Y):
    for k in range(X.shape[1]):
        np.testing.assert_array_equal(np.sort(Y[:, k]), np.sort(X[:, k]))


@pytest.fixture(scope="module")
def matrix_2000():
    return np.random.default_rng(11).normal(size=(2000, 4)).astype(np.float32)


@pytest.mark.parametrize("weights", [None, WEIGHTS4], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("kind", ["pearson", "spearman"])
def test_climb_reaches_the_jax_error(matrix_2000, kind, weights):
    X = matrix_2000
    got = permutation.PermutationCorrelator(seed=1, correlation_type=kind, weights=weights)
    ref = jax_permutation.PermutationCorrelator(seed=1, correlation_type=kind, weights=weights)
    got.set_target(TARGET4)
    ref.set_target(TARGET4)
    Y = got(X).numpy()
    R = np.asarray(ref(X))
    _assert_permutations(X, Y)
    err_got = got._error(_observed(Y, kind), TARGET4)
    err_ref = ref._error(_observed(R, kind), TARGET4)
    assert err_got <= err_ref + ERROR_SLACK, (err_got, err_ref)
    assert err_got < got._error(_observed(X, kind), TARGET4)


def test_until_tolerance_small_rows_and_verbose(capsys):
    X = np.random.default_rng(5).normal(size=(300, 3)).astype(np.float32)
    target = np.array([[1.0, 0.4, 0.0], [0.4, 1.0, 0.3], [0.0, 0.3, 1.0]])
    pc = permutation.PermutationCorrelator(iterations=0, tol=0.03, seed=2).set_target(target)
    Y = pc(X).numpy()
    _assert_permutations(X, Y)
    assert pc._error(np.corrcoef(Y, rowvar=False), target) < 0.03
    # Few rows: the swaps come from permutations (exactly disjoint pairs).
    X = np.random.default_rng(6).normal(size=(12, 2)).astype(np.float32)
    target = np.array([[1.0, 0.9], [0.9, 1.0]])
    pc = permutation.PermutationCorrelator(iterations=50, seed=3, verbose=True)
    Y = pc.set_target(target)(torch.from_numpy(X)).numpy()
    _assert_permutations(X, Y)
    before = pc._error(np.corrcoef(X, rowvar=False), target)
    assert pc._error(np.corrcoef(Y, rowvar=False), target) < before
    out = capsys.readouterr().out
    assert out.startswith("Running permutation correlator for 50 iterations.")
    assert "Permutation correlator finished: error" in out
