"""The megakernel's family branches on the CPU: eligibility, the twin, the text.

* ``cuda_exec.supports`` equals ``pallas_exec.supports`` on a graph of
  every non-table family of the JAX package's sweep
  (``tests/test_distributions.py``), and on Node-valued, bool, zero and
  over-cap shapes of the Newton families;
* the 15 Newton families the kernel takes match the JAX package under both
  packages' ``kernel_safe_special`` (1e-4 of the largest JAX value over q
  in [0.001, 0.999], as outside it);
* the twin (``run_reference``: the kernel's tape, ppf rows under the port's
  ``kernel_safe_special``) of each family graph of ``chip_smoke.py``
  (``benchmarks.family_graphs``) equals the plain executor on the same
  Philox uniforms within 1e-4 of the largest value per kept node: on every
  sample for the closed forms, on samples whose uniforms lie in
  [0.001, 0.999] for the Newton families (in the float32 tails the two
  incomplete functions' rounding moves a frozen lane by more);
* the tape of a family is its standard-variate row and an ``AFFINE`` row
  (``ADD`` for the discrete families), and the generated text calls the
  family's device function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import pallas_exec
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu.ops import special as jax_special
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.ops import ppf, special
from test_distributions import FAMILIES as SWEEP
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
NON_TABLE = SWEEP + [("bernoulli", (0.3,), {}), ("geom", (0.25,), {}), ("randint", (2, 9), {})]
KERNEL_NEWTON = [f for f in benchmarks.FAMILY_SWEEP if f[0] in cuda_exec.INCOMPLETE_FAMILY_CAPS]


def _id(case):
    name, args, _ = case
    return name + "".join(f"-{a:g}" for a in args)


def _supports_pair(jax_sink):
    """(pallas_exec.supports, cuda_exec.supports) on one sink-only graph."""
    mapping = interop.from_reference(jax_sink)
    plan = tcompile.get_plan(mapping[jax_sink._id])
    return (
        pallas_exec.supports(jax_compile.Plan(jax_sink), frozenset({jax_sink._id})),
        cuda_exec.supports(plan, frozenset({mapping[jax_sink._id]._id})),
    )


@pytest.mark.parametrize("case", NON_TABLE, ids=_id)
def test_supports_agrees_with_pallas_exec_per_family(case):
    name, args, kwargs = case
    ref, got = _supports_pair(JaxDistribution(name, *args, **kwargs) * 2 + 1)
    assert ref == got
    in_caps = name not in cuda_exec.INCOMPLETE_FAMILY_CAPS or all(0 < v <= 60 for v in args)
    assert got == (name in cuda_exec._FAMILY_OPS and in_caps)  # gengamma's c < 0 is not


def test_the_whitelists_are_the_tpu_kernels():
    assert set(cuda_exec._CLOSED_FORM_FAMILIES) == pallas_exec._SAFE_FAMILIES
    assert cuda_exec.INCOMPLETE_FAMILY_CAPS == pallas_exec._INCOMPLETE_FAMILY_CAPS
    assert len(cuda_exec._FAMILY_OPS) == 77 and set(cuda_exec._FAMILY_OPS) <= set(ppf.families())


def _uniform():
    return JaxDistribution("uniform", loc=1, scale=1)


SHAPE_CASES = {
    "gamma_in_cap": lambda: JaxDistribution("gamma", a=2.5),
    "gamma_over_cap": lambda: JaxDistribution("gamma", a=100.0),
    "gamma_at_cap": lambda: JaxDistribution("gamma", a=30.0),
    "gamma_node": lambda: JaxDistribution("gamma", a=_uniform()),
    "gamma_bool": lambda: JaxDistribution("gamma", a=True),
    "gamma_numpy": lambda: JaxDistribution("gamma", a=np.float32(2.5)),
    "gamma_positional_zero_loc": lambda: JaxDistribution("gamma", 2.5, 0.0, 1.0),
    "gamma_node_scale": lambda: JaxDistribution("gamma", a=2.5, scale=_uniform()),
    "beta_in_cap": lambda: JaxDistribution("beta", a=2.0, b=5.0),
    "beta_over_cap": lambda: JaxDistribution("beta", a=2.0, b=31.0),
    "beta_negative": lambda: JaxDistribution("beta", a=-2.0, b=5.0),
    "t_at_cap": lambda: JaxDistribution("t", df=60),
    "t_over_cap": lambda: JaxDistribution("t", df=61),
    "t_node": lambda: JaxDistribution("t", df=_uniform() * 4),
    "chi2_in_cap": lambda: JaxDistribution("chi2", df=4),
    "f_in_cap": lambda: JaxDistribution("f", dfn=5, dfd=9),
    "invgamma": lambda: JaxDistribution("invgamma", a=3.0),
    "nakagami": lambda: JaxDistribution("nakagami", nu=1.5),
    "maxwell": lambda: JaxDistribution("maxwell"),
    "maxwell_scale": lambda: JaxDistribution("maxwell", scale=2.0),
    "gengamma_negative_c": lambda: JaxDistribution("gengamma", a=3.0, c=-1.5),
    "argus_over_cap": lambda: JaxDistribution("argus", chi=61.0),
    "erlang": lambda: JaxDistribution("erlang", a=3),
    "pearson3": lambda: JaxDistribution("pearson3", skew=0.8),
    "exponnorm": lambda: JaxDistribution("exponnorm", K=1.5),
    "skewnorm": lambda: JaxDistribution("skewnorm", a=2.0),
    "burr": lambda: JaxDistribution("burr", c=2.0, d=1.5),
    "truncnorm_node": lambda: JaxDistribution("truncnorm", a=-1.0, b=_uniform() + 1, loc=0.5),
}


@pytest.mark.parametrize("name", list(SHAPE_CASES))
def test_supports_agrees_on_shapes(name):
    ref, got = _supports_pair(SHAPE_CASES[name]() + 0)
    assert ref == got


def test_correlated_family_drivers_agree_and_recolour_sort_free():
    for build in (
        lambda: [JaxDistribution("t", df=4), JaxDistribution("beta", a=2, b=3)],
        lambda: [JaxDistribution("gamma", a=2.5), JaxDistribution("gumbel_r")],
        lambda: [JaxDistribution("t", df=100), JaxDistribution("norm")],
        lambda: [JaxDistribution("cosine"), JaxDistribution("norm")],
    ):
        drivers = build()
        sink = (drivers[0] + drivers[1]).correlate(*drivers, corr_mat=[[1, 0.5], [0.5, 1]])
        ref, got = _supports_pair(sink)
        assert ref == got
        port = interop.from_reference(sink)[sink._id]
        plan = tcompile.get_plan(port)
        # Every ported family takes the sort-free branch, as in the JAX package.
        from probabilit_tpu_torch.ops.correlation import ImanConover

        assert tcompile.recolor_eligible(plan, ImanConover)
        assert jax_compile.recolor_eligible(
            jax_compile.Plan(sink), jax_compile.resolve_correlator("imanconover"))


@pytest.mark.parametrize("case", KERNEL_NEWTON, ids=_id)
def test_kernel_newton_family_matches_jax_under_kernel_safe_special(case):
    name, args, kwargs = case
    q = np.linspace(0.001, 0.999, 2001).astype(np.float32)
    with jax_special.kernel_safe_special():
        ref = np.asarray(jax.jit(lambda q: jax_ppf.call(name, q, *args, **kwargs))(jnp.asarray(q)))
    with special.kernel_safe_special():
        got = ppf.call(name, torch.from_numpy(q), *args, **kwargs).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()


GRAPHS = benchmarks.family_graphs()


@pytest.mark.parametrize("label", list(GRAPHS))
def test_twin_matches_plain_executor(label):
    sink, nodes = GRAPHS[label]
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {node._id for _, node in nodes}
    assert cuda_exec.supports(plan, keep)
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep))
    n = 4096
    U = cuda_exec.philox_uniforms(cuda_exec.seed_words(3), n, plan.d)
    twin = cuda_exec.run_tape(tape, U)
    ref = tcompile.build_body(plan, keep)(U)
    newton = label == "newton"
    central = ((U >= 0.001) & (U <= 0.999)).all(dim=1) if newton else torch.ones(n, dtype=bool)
    assert central.float().mean() > 0.9
    for k, nid in enumerate(tape.keep_order):
        want = ref[nid].to(torch.float32)
        assert torch.isfinite(twin[k]).all(), k
        err = (twin[k] - want).abs()[central].max()
        if nid == sink._id:  # a sum: within the sum of its terms' tolerances
            tol = REL_TOL * sum(ref[node._id].abs().max() for _, node in nodes)
        else:
            tol = REL_TOL * want.abs().max()
        assert err <= tol, (k, err, tol)


def test_family_rows_and_device_functions():
    for sink, nodes in GRAPHS.values():
        plan = tcompile.get_plan(sink)
        tape = cuda_exec.lower(plan, [sink._id])
        names = [cuda_exec.OPCODES[row[0]] for row in tape.program]
        for family, _ in nodes:
            op = cuda_exec._FAMILY_OPS[family]
            i = names.index(op)
            assert names[i + 1] == ("ADD" if family in ("bernoulli", "geom", "randint") else "AFFINE")
            if family in cuda_exec.INCOMPLETE_FAMILY_CAPS:  # the Newton tier's row
                assert f"newton_ops::{cuda_exec._NEWTON_FAMILY_ID[family]}," in tape.source
            else:
                assert f"ppf_{family}(" in tape.source
    # The first five families too.
    sink = Distribution("triang", 0.4, loc=1.0, scale=2.0) + 0
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    names = [cuda_exec.OPCODES[row[0]] for row in tape.program]
    assert names[names.index("PPF_TRIANG") + 1] == "AFFINE"
    assert "ppf_triang(" in tape.source


def test_affine_row_takes_node_valued_loc_and_scale():
    loc = Distribution("uniform", loc=1.0, scale=1.0)
    sink = Distribution("beta", 2.0, 3.0, loc=loc, scale=loc * 2) + 0
    plan = tcompile.get_plan(sink)
    tape = cuda_exec.lower(plan, [sink._id])
    U = cuda_exec.philox_uniforms((1, 2), 512, plan.d)
    ref = tcompile.build_body(plan, {sink._id})(U)[sink._id]
    got = cuda_exec.run_tape(tape, U)[0]
    assert (got - ref).abs().max() <= REL_TOL * ref.abs().max()
