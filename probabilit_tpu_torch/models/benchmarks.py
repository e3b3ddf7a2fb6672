"""Benchmark model graphs, ported from ``probabilit_tpu/models/benchmarks.py``.

The README height model, the 10-asset correlated portfolio, the
headline 20-node mixed DAG and the 50-node correlated DAG.  Nodes are
created in the JAX package's order, so ``interop.from_reference`` and
these builders give the same columns and the same correlated variables.

Besides them: ``portfolio_var``, the correlated three-asset model of
``examples/03_portfolio_var.py``, and ``family_graphs``, one sum per group
of the megakernel's family branches at the parameters of the JAX
package's family sweep (``tests/test_distributions.py``).

The table nodes: ``bird_survival`` (the README's composite
Poisson -> binomial chain, BASELINE config 2), ``large_table`` (bench.py's
``bench_large_table`` graph, a 471-knot Poisson table), and
``table_risk``/``table_risk_correlated``, which put every kind of table
node on one tape, at the JAX package's own test sizes
(``tests/test_pallas_exec.py:159-178``).

The path processes: ``path_families``, one path node (or asset view) of
each of the 15 process factories with the closed-form mean and variance
of its terminal value, and ``merton_book``, ``examples/09``'s three-desk
``CorrelatedMerton`` book with each desk's expected terminal price.

The estimators: ``build_project_cost``, ``examples/04_sensitivity.py``'s
project-cost model (labour, materials, delay risk), whose hourly-rate
ladders the scenario sweeps run.

The int32 and bool nodes: ``breach_count`` (and ``_correlated``), a cost
controller's count of overrunning work packages and its penalty tiers,
and ``typed_ops``, a test graph of every int32 and bool operation at the
int32 extremes.  They take the node classes to build with (``lib``,
default this package's), so the tests build the same graph from the JAX
package's classes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from probabilit_tpu_torch.models.distributions import (
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
)
from types import SimpleNamespace

from probabilit_tpu_torch.models import graph as _graph
from probabilit_tpu_torch.models.graph import Add, Exp, Max, Sqrt

__all__ = [
    "height_model",
    "bird_survival",
    "large_table",
    "table_risk",
    "table_risk_correlated",
    "BREACH_BUDGETS",
    "breach_count",
    "breach_count_correlated",
    "TYPED_CONSTANTS",
    "typed_ops",
    "portfolio_model",
    "mixed_dag_20",
    "mixed_correlated_50",
    "portfolio_var",
    "FAMILY_SWEEP",
    "family_graphs",
    "PathFamily",
    "path_families",
    "merton_book",
    "build_project_cost",
]


def height_model():
    """P(male taller than female): two normals and a comparison."""
    male = Distribution("norm", loc=176, scale=7.1)
    female = Distribution("norm", loc=162.5, scale=7.1)
    return male > female


def bird_survival():
    """Composite Poisson -> Binomial chain."""
    eggs_per_nest = Distribution("poisson", mu=3)
    return Distribution("binom", n=eggs_per_nest, p=0.4)


def large_table():
    """``bench.py::bench_large_table``'s graph: a Poisson(2000) through its
    CDF table (471 knots reachable by float32 uniforms), plus 0.0."""
    return Distribution("poisson", mu=2000) + 0.0


# The elicited CDF of ``table_risk`` and ``table_risk_correlated``.
_ELICITED = ([0.0, 0.1, 0.5, 0.9, 1.0], [10.0, 15.0, 20.0, 25.0, 40.0])


def table_risk(seed=2026):
    """A loss that puts every kind of table node on one tape: a claim
    count (poisson(mu=2000), 471 reachable knots) times a severity (a
    512-point ``EmpiricalDistribution`` of lognormal data), plus scenario
    terms: exposures (binom(5000, 0.5)), retries (nbinom(5, 0.5)) times a
    512-value ``DiscreteDistribution`` (Dirichlet weights), defects
    (hypergeom(30, 25, 20), the generic scipy table) and an elicited
    ``CumulativeDistribution``.  The data comes from
    ``np.random.default_rng(seed)``.  Returns ``(loss, {name: node})``.
    """
    rng = np.random.default_rng(seed)
    nodes = {
        "claims": Distribution("poisson", mu=2000),
        "severity": EmpiricalDistribution(rng.lognormal(mean=8.0, sigma=1.0, size=512)),
        "exposures": Distribution("binom", n=5000, p=0.5),
        "retries": Distribution("nbinom", n=5, p=0.5),
        "scenario": DiscreteDistribution(np.arange(512.0), rng.dirichlet(np.ones(512))),
        "defects": Distribution("hypergeom", 30, 25, 20),
        "elicited": CumulativeDistribution(*_ELICITED),
    }
    n = nodes
    loss = (
        n["claims"] * n["severity"]
        + n["exposures"] * n["elicited"] * 0.01
        + n["retries"] * n["scenario"]
        + n["defects"] * 100.0
    )
    return loss, nodes


def table_risk_correlated(seed=2027):
    """Three table drivers correlated with a normal one: a price (normal),
    a unit cost (a 512-point ``EmpiricalDistribution`` of lognormal data),
    a lead time (the elicited ``CumulativeDistribution``) and an order
    count (poisson(mu=400)), through a 4 x 4 target (positive definite,
    so the nearest-correlation repair at sampling keeps it).  The data comes from
    ``np.random.default_rng(seed)``.  Returns ``(margin, {name: node})``.
    """
    rng = np.random.default_rng(seed)
    nodes = {
        "price": Distribution("norm", loc=100.0, scale=15.0),
        "unit_cost": EmpiricalDistribution(rng.lognormal(mean=4.0, sigma=0.3, size=512)),
        "lead_time": CumulativeDistribution(*_ELICITED),
        "orders": Distribution("poisson", mu=400),
    }
    target = np.array([
        [1.0, 0.5, -0.3, 0.6],
        [0.5, 1.0, 0.2, 0.4],
        [-0.3, 0.2, 1.0, -0.2],
        [0.6, 0.4, -0.2, 1.0],
    ])
    n = nodes
    margin = n["orders"] * (n["price"] - n["unit_cost"]) - n["lead_time"] * 50.0
    margin.correlate(*nodes.values(), corr_mat=target)
    return margin, nodes


def _lib(lib):
    """The node classes to build with: ``lib`` or this package's."""
    if lib is not None:
        return lib
    return SimpleNamespace(Distribution=Distribution, **{
        name: getattr(_graph, name) for name in _graph.__all__ if name[0].isupper()})


# The contract budgets of breach_count's ten work packages: each package's
# 85th percentile, rounded to an integer (a Python int, so each is an
# int32 constant).  P(severe) = P(3 or more overruns) = 0.1693 (the exact
# law: a sum of ten independent Bernoullis of p = 0.143 .. 0.153).
BREACH_BUDGETS = (121, 126, 131, 136, 141, 146, 130, 143, 155, 168)


def breach_count(lib=None):
    """A cost controller's breach model: ten work-package costs (six
    ``triang(c=0.3, loc=80 + 5i, scale=60)``, four
    ``lognorm(s=0.25, scale=100 + 10j)``), the int32 count of packages
    over their integer budgets, whether three or more overrun (``severe``),
    whether any runs 25% over (``late``), the contract's penalty tiers,
    and the loss: the total cost plus 40 a tier plus 25 if late.

    Returns ``(loss, {"costs": [...], "overruns", "severe", "late",
    "tier"})``: overruns and tier are int32, severe and late bool, loss
    float32, as ``jnp`` types them.
    """
    g = _lib(lib)
    costs = [g.Distribution("triang", c=0.3, loc=80 + 5 * i, scale=60) for i in range(6)]
    costs += [g.Distribution("lognorm", s=0.25, scale=100 + 10 * j) for j in range(4)]
    overruns = g.Add(*[(c > b) * 1 for c, b in zip(costs, BREACH_BUDGETS)])
    severe = overruns >= 3
    late = g.Any(*[c > b * 1.25 for c, b in zip(costs, BREACH_BUDGETS)])
    penalty = g.Max(overruns - 2, 0)
    tier = penalty // 2 + penalty % 2
    loss = g.Add(*costs) + tier * 40 + late * 25
    return loss, {"costs": costs, "overruns": overruns, "severe": severe, "late": late,
                  "tier": tier}


def breach_count_correlated(lib=None, rho=0.5):
    """``breach_count`` with the ten costs correlated at ``rho`` (K = 10):
    packages that share a supplier overrun together.  The target is
    declared on ``overruns``, which ``severe``, ``tier`` and ``loss`` all
    read, so each of their graphs carries it."""
    loss, nodes = breach_count(lib)
    corr = np.full((10, 10), rho)
    np.fill_diagonal(corr, 1.0)
    nodes["overruns"].correlate(*nodes["costs"], corr_mat=corr)
    return loss, nodes


# The int32 operands of typed_ops: the extremes, the first integer float32
# cannot hold, zero, -1 and two small ones of either sign.
TYPED_CONSTANTS = (2**31 - 1, -2**31, 2**24 + 1, 0, -1, 7, -3)


def typed_ops(lib=None):
    """A test graph of every int32 and bool operation, not a user's
    model.  Six standard uniforms give per-sample bools ``u_j > 0.5``,
    which pick each int32 operand from ``TYPED_CONSTANTS``, so a lane
    meets both sides of every branch: divisors 0 and -1, wrap-around and
    none.  A wide int32 result is kept as its two halves (``// 2^16`` and
    ``% 2^16``), each exact in float32.  Every value here is computed
    from constants and uniform draws alone, so K1 and its twin agree on
    it bitwise.

    Returns ``(sink, leaves, r7)``: ``leaves`` maps a label to a node
    whose float32 value is exact; the int32 sink adds every leaf (the first
    is an int, so the bools add as integers), those labelled in ``r7``
    times 0 (an integer power with a negative exponent, where
    the plain executor gives 0 and jnp other values: ROADMAP C, R7).
    """
    g = _lib(lib)
    big, low, wide, zero, minus_one, seven, minus_three = TYPED_CONSTANTS
    u = [g.Distribution("uniform") for _ in range(6)]
    bit = [x > 0.5 for x in u]

    def pick(j, a, b):
        return bit[j] * a + (u[j] <= 0.5) * b

    x = pick(0, big, minus_three)
    y = pick(1, low, seven)
    div = pick(2, zero, minus_one)
    w = pick(3, wide, seven)
    exponent = pick(4, 2, minus_three)
    num = pick(5, zero, minus_three)
    near = pick(2, wide, wide - 1)
    b0, b1 = bit[0], bit[1]
    wide_results = {
        "add": x + y, "sub": y - x, "mul": x * w, "square": g.Square(w),
        "floordiv": y // div, "floordiv_signs": x // w, "pow": w ** 2, "bool_plus_int": b0 + x,
        "int_minus_bool": y - b1, "pow_negative": w ** exponent,
    }
    # -y and |y| are -2^31 or +-7, exact as they are.  (XLA takes |y| to be
    # non-negative when it fuses |y| // 2^16, which it is not at -2^31.)
    leaves = {"neg": -y, "abs": g.Abs(y)}
    for label, value in wide_results.items():
        leaves[f"{label}_hi"] = value // 65536
        leaves[f"{label}_lo"] = value % 65536
    leaves.update({
        "floordiv_zero": num // div, "mod": y % div,
        "mod_signs": x % w, "floor": g.Floor(div), "ceil": g.Ceil(exponent),
        "sign_zero": g.Sign(div), "sign": g.Sign(x),
        "gt": near > wide - 1, "ge": near >= wide, "lt": near < wide, "le": near <= wide - 1,
        "eq": g.Equal(near, wide), "ne": g.NotEqual(near, wide), "isclose": g.IsClose(near, wide),
        "all_ints": g.All(x, div), "any_ints": g.Any(div, num),
        "bool_or": b0 + b1, "bool_and": b0 * b1, "bool_max": g.Max(b0, b1),
        "bool_min": g.Min(b0, b1), "bool_floordiv": b0 // b1, "bool_mod": b0 % b1,
        "bool_pow": b0 ** b1, "bool_square": g.Square(b0), "bool_abs": g.Abs(b0),
        "bool_floor": g.Floor(b1), "bool_ceil": g.Ceil(b0),
    })
    r7 = ("pow_negative_hi", "pow_negative_lo")
    # The R7 leaves enter the sink times 0: in the graph, not in its value.
    sink = g.Add(*(node * 0 if label in r7 else node for label, node in leaves.items()))
    return sink, leaves, r7


def portfolio_model(d=10, target_corr=0.3):
    """d correlated lognormal assets, equal-weight portfolio value.

    Iman-Conover induces a uniform ``target_corr`` across all assets.
    """
    assets = [Distribution("lognorm", s=0.2, scale=100.0) for _ in range(d)]
    total = assets[0]
    for a in assets[1:]:
        total = total + a
    corr = np.full((d, d), target_corr)
    np.fill_diagonal(corr, 1.0)
    total = total.correlate(*assets, corr_mat=corr)
    return total


def mixed_dag_20():
    """The headline 20-node mixed DAG (8 distributions + transforms).

    Mixes the five closed-form families (norm, uniform, expon, lognorm,
    triang) with arithmetic/transcendental transforms, shaped like a small
    risk model: price x volume with costs, floors and a tax-like
    nonlinearity.
    """
    price = Distribution("lognorm", s=0.25, scale=50.0)
    volume = Distribution("triang", c=0.4, loc=800, scale=600)
    fx = Distribution("norm", loc=1.0, scale=0.05)
    unit_cost = Distribution("uniform", loc=20, scale=15)
    fixed_cost = Distribution("norm", loc=5000, scale=400)
    delay = Distribution("expon", scale=0.1)
    demand_shock = Distribution("norm", loc=0.0, scale=1.0)
    tax_rate = Distribution("uniform", loc=0.2, scale=0.1)

    eff_volume = volume * Exp(demand_shock * 0.1)
    revenue = price * eff_volume * fx
    cost = unit_cost * eff_volume + fixed_cost
    gross = revenue - cost
    penalty = delay * revenue
    pre_tax = gross - penalty
    taxed = pre_tax * (1 - tax_rate)
    profit = Max(taxed, pre_tax * 0.05) + Sqrt(fx * fx)
    return profit


def mixed_correlated_50():
    """The ~50-node mixed DAG with ten correlated drivers.

    The target correlation is deliberately invalid (strong a-b and b-c
    correlation with strong negative a-c is not PSD), so sampling runs the
    nearest-correlation repair; a lattice of ~40 transforms follows.
    """
    drivers = [
        Distribution("norm", loc=0.0, scale=1.0),
        Distribution("lognorm", s=0.3, scale=10.0),
        Distribution("uniform", loc=-1, scale=2),
        Distribution("expon", scale=0.5),
        Distribution("triang", c=0.5, loc=0, scale=2),
        Distribution("norm", loc=5.0, scale=2.0),
        Distribution("uniform", loc=0, scale=1),
        Distribution("lognorm", s=0.5, scale=1.0),
        Distribution("norm", loc=-2.0, scale=0.5),
        Distribution("expon", scale=2.0),
    ]
    corr = np.eye(10)
    corr[0, 1] = corr[1, 0] = 0.9
    corr[1, 2] = corr[2, 1] = 0.9
    corr[0, 2] = corr[2, 0] = -0.9
    for i in range(3, 10):
        corr[0, i] = corr[i, 0] = 0.3

    layer = []
    for i in range(0, 10, 2):
        layer.append(drivers[i] * drivers[i + 1] + i)
    total = layer[0]
    for term in layer[1:]:
        total = Max(total, term) + Sqrt(Exp(term * 0.01))
    total = total.correlate(*drivers, corr_mat=corr)
    return total


def portfolio_var():
    """``examples/03_portfolio_var.py::build_portfolio``: equities
    (lognormal), bonds (normal) and commodities (Student t, df = 4) with
    an analyst's pairwise correlations, repaired to the nearest
    correlation matrix.  Returns ``(portfolio, {name: asset})``."""
    from probabilit_tpu_torch.ops.ncm import nearest_correlation_matrix
    from probabilit_tpu_torch.utils.helpers import build_corrmat

    equities = Distribution("lognorm", s=0.25, scale=1.0)
    bonds = Distribution("norm", loc=1.02, scale=0.05)
    commodities = Distribution("t", df=4, loc=1.0, scale=0.15)
    guess = build_corrmat(
        [
            ((0, 1), np.array([[1.0, 0.4], [0.4, 1.0]])),
            ((0, 2), np.array([[1.0, 0.6], [0.6, 1.0]])),
            ((1, 2), np.array([[1.0, -0.3], [-0.3, 1.0]])),
        ]
    )
    target = nearest_correlation_matrix(guess)
    portfolio = 0.5 * equities + 0.3 * bonds + 0.2 * commodities
    portfolio.correlate(equities, bonds, commodities, corr_mat=target)
    return portfolio, {"equities": equities, "bonds": bonds, "commodities": commodities}


# (family, args, kwargs): the first sweep entry of every family the
# megakernel takes beside the first five, in tests/test_distributions.py's
# order (Newton families within their shape caps).
FAMILY_SWEEP = (
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
    ("reciprocal", (0.01, 10.0), {}),
    ("skewcauchy", (0.5,), {}),
    ("kappa4", (1.0, 2.0), {}),
    ("crystalball", (1.5, 3.0), {}),
    ("bernoulli", (0.3,), {}),
    ("geom", (0.25,), {}),
    ("randint", (2, 9), {}),
    ("gamma", (2.5,), {"scale": 1.5}),
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
    ("loggamma", (2.0,), {}),
    ("rdist", (3.0,), {}),
    ("argus", (2.0,), {}),
)

_NEWTON_SWEEP = {
    "gamma", "chi2", "chi", "maxwell", "invgamma", "nakagami", "beta", "betaprime", "t", "f",
    "dgamma", "gengamma", "loggamma", "rdist", "argus",
}


def family_graphs():
    """Five graphs whose nodes are the ``FAMILY_SWEEP`` families, each the
    sum of at most 15 of them: four of closed forms, one of the Newton
    families.  Returns ``{label: (sink, [(family, node), ...])}``."""
    closed = [f for f in FAMILY_SWEEP if f[0] not in _NEWTON_SWEEP]
    newton = [f for f in FAMILY_SWEEP if f[0] in _NEWTON_SWEEP]
    groups = {f"closed_form_{i}": closed[i::4] for i in range(4)}
    groups["newton"] = newton
    graphs = {}
    for label, group in groups.items():
        nodes = [(name, Distribution(name, *args, **kwargs)) for name, args, kwargs in group]
        graphs[label] = (Add(*(node for _, node in nodes)), nodes)
    return graphs


class PathFamily(NamedTuple):
    """One process factory's path surface (a path node, or an asset view),
    whether it runs a Newton ppf, and its terminal value's closed-form mean
    and variance (None where there is none)."""

    surface: object
    newton: bool
    mean: float
    var: float | None


def ou_drift(t, x):
    return 1.5 * (0.5 - x)


def gbm_drift(t, x):
    return 0.05 * x


def gbm_diffusion(t, x):
    return 0.2 * x


MARKOV_P3 = [[0.8, 0.15, 0.05], [0.1, 0.8, 0.1], [0.05, 0.15, 0.8]]
MARKOV_VALUES = [1.0, 2.0, 5.0]
REGIME_P2 = [[0.95, 0.05], [0.1, 0.9]]
REGIME_MU, REGIME_SIGMA = [0.08, -0.02], [0.15, 0.4]


def _merton_moments(s0, mu, sigma, T, jumps):
    """E[S_T], Var[S_T] of s0 exp((mu - sigma^2/2) T + sigma W_T + sum of
    compound-Poisson normal jumps), ``jumps`` a list of (rate, mean, std)."""
    m1 = s0 * np.exp(mu * T + sum(r * T * np.expm1(m + s * s / 2) for r, m, s in jumps))
    m2 = s0 * s0 * np.exp(
        2 * mu * T + sigma**2 * T + sum(r * T * np.expm1(2 * m + 2 * s * s) for r, m, s in jumps)
    )
    return m1, m2 - m1 * m1


def path_families(steps=252):
    """``{name: PathFamily}``, one entry per process factory, at T = 1
    unless noted and ``steps`` grid points (the parameters of the port's
    CPU path tests).  The SDE runs Milstein on dX = 0.05 X dt + 0.2 X dW
    (its scheme's own moments), Heston's mean is s0 e^{mu T} up to the
    trapezoid's O(dt^2)."""
    import probabilit_tpu_torch as pt

    dt = 1.0 / steps
    e15 = np.exp(-1.5)
    ek = np.exp(-2.0)
    g = np.sqrt(2.0**2 - 0.5**2)
    m1 = 1.0 + 0.05 * dt
    m2 = m1**2 + 0.04 * dt + 0.5 * 0.2**4 * dt * dt
    p = np.linalg.matrix_power(np.array(MARKOV_P3), steps)[0]
    values = np.array(MARKOV_VALUES)
    P2, mu2, sd2 = np.array(REGIME_P2), np.array(REGIME_MU), np.array(REGIME_SIGMA)

    def regime(m):
        D = np.diag(np.exp(m * mu2 * dt + 0.5 * m * (m - 1) * sd2**2 * dt))
        return 100.0**m * (np.linalg.matrix_power(D @ P2, steps - 1) @ D @ np.ones(2))[0]

    corr2 = [[1.0, 0.6], [0.6, 1.0]]
    merton = _merton_moments(100.0, 0.03, 0.2, 1.0, [(1.0, -0.05, 0.1)])
    cmerton = _merton_moments(100.0, 0.03, 0.2, 1.0, [(0.5, -0.05, 0.1), (0.2, -0.1, 0.05)])
    return {
        "brownian": PathFamily(
            pt.BrownianMotion(x0=1.0, drift=0.3, diffusion=1.5, T=2.0, steps=steps),
            False, 1.6, 1.5**2 * 2.0),
        "gbm": PathFamily(
            pt.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=steps),
            False, 100 * np.exp(0.05), 1e4 * np.exp(0.1) * np.expm1(0.04)),
        "ou": PathFamily(
            pt.OrnsteinUhlenbeck(x0=2.0, theta=1.5, mu=0.5, sigma=0.8, steps=steps),
            False, 0.5 + 1.5 * e15, 0.64 * (1 - e15 * e15) / 3.0),
        "poisson": PathFamily(pt.PoissonProcess(rate=3.0, T=2.0, steps=steps), False, 6.0, 6.0),
        "merton": PathFamily(
            pt.MertonJumpDiffusion(s0=100, mu=0.03, sigma=0.2, jump_rate=1.0,
                                    jump_mean=-0.05, jump_std=0.1, steps=steps),
            False, *merton),
        "correlated_gbm": PathFamily(
            pt.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], corr2, steps=steps)[0],
            False, 100 * np.exp(0.03), 1e4 * np.exp(0.06) * np.expm1(0.04)),
        "correlated_merton": PathFamily(
            pt.CorrelatedMerton([100.0, 50.0], [0.03, 0.02], [0.2, 0.3], [[1, 0.5], [0.5, 1]],
                                 jump_rate=[0.5, 1.0], jump_mean=-0.05, common_rate=0.2,
                                 common_mean=-0.1, common_std=0.05, steps=steps)[0],
            False, *cmerton),
        "variance_gamma": PathFamily(
            pt.VarianceGamma(mu=0.1, theta=-0.2, sigma=0.3, nu=0.25, T=2.0, steps=steps),
            True, (0.1 - 0.2) * 2.0, (0.3**2 + 0.25 * 0.2**2) * 2.0),
        "normal_inverse_gaussian": PathFamily(
            pt.NormalInverseGaussian(alpha=2.0, beta=-0.5, delta=0.8, mu=0.1, T=1.5,
                                      steps=steps),
            True, (0.1 - 0.8 * 0.5 / g) * 1.5, 0.8 * 4.0 / g**3 * 1.5),
        "cox_ingersoll_ross": PathFamily(
            pt.CoxIngersollRoss(v0=0.03, kappa=2.0, theta=0.04, sigma=0.3, steps=steps),
            True, 0.04 + (0.03 - 0.04) * ek,
            0.03 * 0.09 * ek * (1 - ek) / 2.0 + 0.04 * 0.09 * (1 - ek) ** 2 / 4.0),
        "heston": PathFamily(
            pt.Heston(s0=100, mu=0.04, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7,
                       steps=steps),
            True, 100 * np.exp(0.04), None),
        "correlated_heston": PathFamily(
            pt.CorrelatedHeston([100.0, 50.0], [0.0, 0.0], v0=0.04, kappa=2.0, theta=0.04,
                                 sigma=0.3, rho=[-0.5, -0.3], corr=corr2, steps=steps)[0],
            True, 100.0, None),
        "sde_milstein": PathFamily(
            pt.SDE(gbm_drift, gbm_diffusion, x0=100.0, steps=steps, scheme="milstein"),
            False, 100 * m1**steps, 1e4 * (m2**steps - m1 ** (2 * steps))),
        "markov_chain": PathFamily(
            pt.MarkovChain(MARKOV_P3, x0=0, values=MARKOV_VALUES, steps=steps),
            False, p @ values, p @ values**2 - (p @ values) ** 2),
        "regime_switching_gbm": PathFamily(
            pt.RegimeSwitchingGBM(100.0, REGIME_MU, REGIME_SIGMA, REGIME_P2, steps=steps),
            False, regime(1), regime(2) - regime(1) ** 2),
    }


def merton_book(steps=64):
    """``examples/09``'s three-desk book: ``CorrelatedMerton`` views with
    correlated diffusions, idiosyncratic jumps and a common crash stream
    (intensity 0.3 a year, mean -8%) loaded [1, 0.8, 0.5].  Returns
    ``(views, expected terminal prices)``."""
    from probabilit_tpu_torch.models.processes import CorrelatedMerton

    mu, sigma = [0.05, 0.04, 0.03], [0.2, 0.25, 0.15]
    rates, loads = [0.5, 0.3, 0.0], [1.0, 0.8, 0.5]
    views = CorrelatedMerton(
        s0=[100.0, 100.0, 100.0], mu=mu, sigma=sigma,
        corr=[[1, 0.5, 0.2], [0.5, 1, 0.3], [0.2, 0.3, 1]], jump_rate=rates, jump_mean=-0.04,
        jump_std=0.08, common_rate=0.3, common_mean=-0.08, common_std=0.04, loadings=loads,
        T=1.0, steps=steps,
    )
    means = [
        _merton_moments(100.0, mu[i], sigma[i], 1.0,
                        [(rates[i], -0.04, 0.08), (0.3, -0.08 * loads[i], 0.04 * loads[i])])[0]
        for i in range(3)
    ]
    return views, means


def build_project_cost():
    """``examples/04_sensitivity.py``'s project-cost model: labour,
    materials and delay risk.  Returns ``(total, {name: variable})``."""
    labour_hours = Distribution("triang", c=0.3, loc=800, scale=600)
    hourly_rate = Distribution("norm", loc=95.0, scale=8.0)
    materials = Distribution("lognorm", s=0.35, scale=40_000.0)
    delay_months = Distribution("expon", scale=1.5)
    overhead_rate = Distribution("uniform", loc=0.10, scale=0.08)

    base = labour_hours * hourly_rate + materials
    delay_penalty = delay_months * 12_000.0
    total = (base + delay_penalty) * (1.0 + overhead_rate)
    variables = {
        "labour_hours": labour_hours,
        "hourly_rate": hourly_rate,
        "materials": materials,
        "delay_months": delay_months,
        "overhead_rate": overhead_rate,
    }
    return total, variables
