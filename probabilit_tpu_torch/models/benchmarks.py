"""Benchmark model graphs, ported from ``probabilit_tpu/models/benchmarks.py``.

The README height model, the 10-asset correlated portfolio, the
headline 20-node mixed DAG and the 50-node correlated DAG.  Nodes are
created in the JAX package's order, so ``interop.from_reference`` and
these builders give the same columns and the same correlated variables.
"""

from __future__ import annotations

import numpy as np

from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.models.graph import Exp, Max, Sqrt

__all__ = ["height_model", "portfolio_model", "mixed_dag_20", "mixed_correlated_50"]


def height_model():
    """P(male taller than female): two normals and a comparison."""
    male = Distribution("norm", loc=176, scale=7.1)
    female = Distribution("norm", loc=162.5, scale=7.1)
    return male > female


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
