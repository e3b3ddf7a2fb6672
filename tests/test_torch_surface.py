"""The rest of the reference surface in the port (A10b), on the CPU.

The parity modules ``probabilit_tpu_torch.modeling``, ``.correlation``
and ``.distributions`` export every name the JAX package's do, the
package's ``__all__`` holds every name of the JAX package's, ``treeprint``
prints the JAX package's text for the same graph, and ``plot`` returns a
seaborn grid (this machine has seaborn and pandas; the card's has not,
so no phase of ``chip_smoke.py`` calls it).
"""

import contextlib
import importlib
import io

import numpy as np
import pytest

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from probabilit_tpu import inspection as jax_inspection
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu_torch import config, inspection
from probabilit_tpu_torch.models import benchmarks
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


@pytest.mark.parametrize("name", ["modeling", "correlation", "distributions"])
def test_parity_modules_export_every_jax_name(name):
    ref = importlib.import_module(f"probabilit_tpu.{name}")
    got = importlib.import_module(f"probabilit_tpu_torch.{name}")
    assert list(got.__all__) == list(ref.__all__)
    for attr in dir(ref):  # the JAX package's own objects, underscored helpers too
        if getattr(getattr(ref, attr), "__module__", "").startswith("probabilit_tpu."):
            assert getattr(got, attr).__module__.startswith("probabilit_tpu_torch."), attr


def test_package_exports_every_jax_name():
    assert set(jax_pkg.__all__) <= set(pt.__all__)
    for name in ("american_price", "american_greeks", "plot"):
        assert getattr(pt, name).__module__.startswith("probabilit_tpu_torch")


def _printed(fn, node):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(node)
    return out.getvalue()


def test_treeprint_text_equals_jax():
    got = _printed(inspection.treeprint, benchmarks.mixed_dag_20())
    ref = _printed(jax_inspection.treeprint, jax_benchmarks.mixed_dag_20())
    assert got == ref and got.count("\n") > 20
    x = pt.Distribution("expon")
    y = jax_pkg.Distribution("expon")
    assert _printed(inspection.treeprint, pt.Distribution("norm", loc=1, scale=x) + x - x**2) == \
        _printed(jax_inspection.treeprint, jax_pkg.Distribution("norm", loc=1, scale=y) + y - y**2)


def test_plot_returns_a_seaborn_grid():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn

    a, b = pt.Distribution("norm"), pt.Distribution("expon")
    grid = pt.plot(a, b, corr=0.5, sample_kwargs=dict(size=500, random_state=0))
    assert isinstance(grid, seaborn.PairGrid)
    assert list(grid.data.columns) == ["var_1", "var_2"] and len(grid.data) == 500
    assert not hasattr(a, "samples_")  # the caller's graph is untouched
    assert np.corrcoef(grid.data["var_1"], grid.data["var_2"])[0, 1] > 0.3
    plt.close("all")
    with pytest.raises(ValueError, match="vector-valued"):
        pt.plot(pt.GeometricBrownianMotion(steps=4))
