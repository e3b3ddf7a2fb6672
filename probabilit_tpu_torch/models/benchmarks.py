"""Benchmark model graphs, ported from ``probabilit_tpu/models/benchmarks.py``.

Only the two graphs of the first slice so far: the README height model
and the headline 20-node mixed DAG.
"""

from __future__ import annotations

from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.models.graph import Exp, Max, Sqrt

__all__ = ["height_model", "mixed_dag_20"]


def height_model():
    """P(male taller than female): two normals and a comparison."""
    male = Distribution("norm", loc=176, scale=7.1)
    female = Distribution("norm", loc=162.5, scale=7.1)
    return male > female


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
