"""The port's column-sharded Iman-Conover against the JAX package's, on
the CPU.

Each package under its own 8-shard CPU mesh (the port's ``[cpu] * 8``,
the JAX package's conftest devices), ``ImanConover()(X)`` on
``test_parallel.py``'s two inputs: the padded one
within that file's tolerances (in fact equal), the divisible one equal
but for one swapped near tie, which the two packages already part at
without a mesh.  Most of the file's time is the JAX package's
Iman-Conover programs compiling under its mesh.
"""

import jax
import numpy as np
import pytest
import torch

from probabilit_tpu.ops.correlation import ImanConover as JaxImanConover
from probabilit_tpu.parallel import make_mesh as jax_make_mesh
from probabilit_tpu.parallel import use_mesh as jax_use_mesh
from probabilit_tpu_torch import config
from probabilit_tpu_torch.ops.correlation import ImanConover
from probabilit_tpu_torch.parallel import make_mesh, set_mesh, use_mesh
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)
from test_torch_parallel import TestColumnShardedImanConover as _Inputs

CPU = torch.device("cpu")

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)
        set_mesh(None)


def _under(n_dev, fn):
    with use_mesh(make_mesh([CPU] * n_dev)):
        return fn()


@needs_devices
class TestImanConoverAgainstJax:
    """Each package's Iman-Conover under its own 8-shard CPU mesh."""

    def test_imanconover_divisible_matches_jax_but_one_near_tie(self):
        # Without a mesh the port and the JAX package already part on this
        # input at one near tie: column 6's recoloured scores at rows 491
        # and 1485 are 1.1443305 and 1.1443306, one float32 ulp apart, and
        # the packages' scores differ by an ulp (ndtri), so the two rows
        # swap (ROADMAP, divergences).  The mesh adds nothing: the port's
        # sharded result is its unsharded one bitwise (and the JAX
        # package's, test_parallel.py), so they part at the same entries.
        X, C = _Inputs._divisible()
        with jax_use_mesh(jax_make_mesh()):
            ref = np.asarray(JaxImanConover().set_target(C)(X))
        got0 = np.asarray(ImanConover().set_target(C)(X))
        got = np.asarray(_under(8, lambda: ImanConover().set_target(C)(X)))
        np.testing.assert_array_equal(got, got0)
        rows, cols = np.nonzero(got != ref)
        assert rows.tolist() == [491, 1485] and cols.tolist() == [6, 6]
        assert got[491, 6] == ref[1485, 6] and got[1485, 6] == ref[491, 6]
        np.testing.assert_array_equal(np.nonzero(got0 != ref)[0], rows)

    def test_imanconover_padded_matches_jax(self):
        X, C = _Inputs._padded()
        with jax_use_mesh(jax_make_mesh()):
            ref = np.asarray(JaxImanConover().set_target(C)(X))
        got = np.asarray(_under(8, lambda: ImanConover().set_target(C)(X)))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        for k in range(5):
            np.testing.assert_array_equal(np.sort(got[:, k]), np.sort(ref[:, k]))
