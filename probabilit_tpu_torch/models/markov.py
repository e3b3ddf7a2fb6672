"""Discrete-state Markov chains and regime-switching diffusion paths.

Port of ``probabilit_tpu/models/markov.py``.  Two families on the
path-node contract (``models/processes.py``):

* ``MarkovChain``: a K-state chain on the grid, one transition a step
  from a row-stochastic matrix ``P``; the path holds each step's state
  value (``values[k]``, by default the index), so functionals compose;
* ``RegimeSwitchingGBM``: a geometric Brownian asset whose drift and
  volatility switch with a hidden chain (Hamilton's model): interval
  ``k`` uses the parameters of the state at its left endpoint, so each
  increment is exactly lognormal given the regime path.

The chain step (``_chain_scan``) reads the cumulative transition row of
each sample's current state with a gather and counts the row's entries
below the step's uniform: the inverse transform of the row.  The JAX
package forms the same row as a one-hot ``(n, K) @ (K, K)`` product
(TPU gathers are slow); one-hot times the table is the table's row
exactly, so both give the same state indices.  The uniforms and normals
are drawn before the loop over the steps.  No Brownian bridge: a
discrete recursion has no bridge, and the asset normals of the
regime-switching path are modulated per interval by the regime.

>>> chain = MarkovChain([[0.9, 0.1], [0.2, 0.8]], x0=0, steps=4)
>>> chain.terminal()
PathFunctional(MarkovChainPath(K=2, x0=0, T=1, steps=4), 'terminal')
"""

from __future__ import annotations

import numpy as np
import torch

from probabilit_tpu_torch.models.processes import (
    PathDistribution,
    normal,
    time_cumsum,
    sample_major,
    time_major,
    uniform,
)
from probabilit_tpu_torch.ops import special as _special

__all__ = ["MarkovChain", "RegimeSwitchingGBM", "MarkovChainPath", "RegimeSwitchingGBMPath"]


def _validate_transition(transition):
    P = np.asarray(transition, np.float64)
    if P.ndim != 2 or P.shape[0] != P.shape[1]:
        raise ValueError(f"transition must be a square matrix, got {P.shape}.")
    if P.shape[0] < 2:
        raise ValueError("A Markov chain needs at least 2 states.")
    if (P < 0).any():
        raise ValueError("transition probabilities must be non-negative.")
    rows = P.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=1e-9):
        raise ValueError(f"transition rows must sum to 1, got row sums {rows}.")
    return P


def _chain_scan(u, cum, state0):
    """(n, steps) uniforms -> (n, steps) int64 state indices.

    Step k's next state is ``sum_j 1{u_k > cum[state, j]}`` (capped at
    K - 1), the inverse transform of the current state's transition row
    ``cum[state]`` (float in ``u``'s dtype, as the JAX package rounds it).
    """
    n, steps = u.shape
    cum_t = torch.as_tensor(cum, dtype=u.dtype, device=u.device)
    last = cum_t.shape[0] - 1
    u = time_major(u)
    state = torch.full((n,), state0, dtype=torch.int64, device=u.device)
    states = torch.empty((steps, n), dtype=torch.int64, device=u.device)
    for k in range(steps):
        nxt = (u[k, :, None] > cum_t[state]).sum(dim=1)
        state = torch.clamp(nxt, max=last)
        states[k] = state
    return sample_major(states)


class MarkovChainPath(PathDistribution):
    """K-state discrete-time Markov chain on the grid (exact law):
    ``at(k)`` has the law ``e_{x0} P^{k+1}`` over the state values."""

    _param_slots = ()

    def __init__(self, transition, x0=0, values=None, T=1.0, steps=252):
        P = _validate_transition(transition)
        K = P.shape[0]
        x0 = int(x0)
        if not 0 <= x0 < K:
            raise ValueError(f"x0 must be a state index in [0, {K}), got {x0}.")
        if values is None:
            vals = np.arange(K, dtype=np.float64)
        else:
            vals = np.asarray(values, np.float64)
            if vals.shape != (K,):
                raise ValueError(f"values must have shape ({K},), got {vals.shape}.")
        self.transition = P
        self.K = K
        self.x0 = x0
        self.values = vals
        self._cum = np.cumsum(P, axis=1)
        super().__init__(steps, T)

    def __repr__(self):
        return f"MarkovChainPath(K={self.K}, x0={self.x0}, T={self.T:g}, steps={self.steps})"

    def _static_signature(self):
        return (
            "MarkovChainPath", self.transition.tobytes(), self.x0, self.values.tobytes(),
            self.T, self.steps,
        )

    def _increments(self, gen, n, dtype):
        return uniform(gen, (n, self.steps), dtype)

    def _increments_from_slab(self, slab, dtype):
        return slab.to(dtype)

    def _path_from_increments(self, u):
        states = _chain_scan(u, self._cum, self.x0)
        values = torch.as_tensor(self.values, dtype=u.dtype, device=u.device)
        return values[states]


class RegimeSwitchingGBMPath(PathDistribution):
    """GBM with chain-modulated drift and volatility (Hamilton regimes).

    ``dS = mu[s_t] S dt + sigma[s_t] S dW`` with ``s_t`` a K-state chain
    that moves at grid points; interval ``k`` uses the parameters of the
    state at its left endpoint, so given the regime path every increment
    is exactly lognormal (regimes cannot switch mid-interval).
    """

    _param_slots = ()

    def __init__(self, s0, mu, sigma, transition, x0_state=0, T=1.0, steps=252):
        P = _validate_transition(transition)
        K = P.shape[0]
        s0 = float(s0)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        mu = np.asarray(mu, np.float64)
        sigma = np.asarray(sigma, np.float64)
        if mu.shape != (K,) or sigma.shape != (K,):
            raise ValueError(
                f"mu and sigma must each have shape ({K},) matching the "
                f"transition matrix, got {mu.shape} and {sigma.shape}."
            )
        if (sigma <= 0).any():
            raise ValueError("every regime sigma must be positive.")
        x0_state = int(x0_state)
        if not 0 <= x0_state < K:
            raise ValueError(f"x0_state must be a state index in [0, {K}), got {x0_state}.")
        self.s0 = s0
        self.mu = mu
        self.sigma = sigma
        self.transition = P
        self.K = K
        self.x0_state = x0_state
        self._cum = np.cumsum(P, axis=1)
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"RegimeSwitchingGBMPath(s0={self.s0:g}, K={self.K}, "
            f"x0_state={self.x0_state}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "RegimeSwitchingGBMPath", self.s0, self.mu.tobytes(), self.sigma.tobytes(),
            self.transition.tobytes(), self.x0_state, self.T, self.steps,
        )

    @property
    def _q_width(self):
        # Two drivers a step: the chain's uniform and the asset's normal.
        return 2 * self.steps

    def _increments(self, gen, n, dtype):
        shape = (n, self.steps)
        u = uniform(gen, shape, dtype)
        z = normal(gen, shape, dtype)
        return torch.stack([u, z], dim=2)

    def _increments_from_slab(self, slab, dtype):
        s = self.steps
        u = slab[:, :s].to(dtype)
        z = _special.ndtri_fast(slab[:, s:].to(dtype))
        return torch.stack([u, z], dim=2)

    def _path_from_increments(self, inc):
        dtype, device = inc.dtype, inc.device
        dt = self.T / self.steps
        u, z = inc[:, :, 0], inc[:, :, 1]
        states = _chain_scan(u, self._cum, self.x0_state)
        # Interval k uses the state at its left endpoint: x0_state for
        # interval 0, then the post-transition states shifted right.
        prev = torch.cat(
            [torch.full((states.shape[0], 1), self.x0_state, dtype=states.dtype, device=device),
             states[:, :-1]],
            dim=1,
        )
        mu_k = torch.as_tensor(self.mu, dtype=dtype, device=device)[prev]
        sd_k = torch.as_tensor(self.sigma, dtype=dtype, device=device)[prev]
        dlog = (mu_k - 0.5 * sd_k * sd_k) * dt + sd_k * (dt**0.5) * z
        return self.s0 * torch.exp(time_cumsum(dlog))


def MarkovChain(transition, x0=0, values=None, T=1.0, steps=252):
    """K-state Markov chain path node; see :class:`MarkovChainPath`.

    >>> MarkovChain([[0.9, 0.1], [0.2, 0.8]], x0=1, steps=8)
    MarkovChainPath(K=2, x0=1, T=1, steps=8)
    """
    return MarkovChainPath(transition, x0=x0, values=values, T=T, steps=steps)


def RegimeSwitchingGBM(s0, mu, sigma, transition, x0_state=0, T=1.0, steps=252):
    """Regime-switching GBM path node; see :class:`RegimeSwitchingGBMPath`.

    >>> RegimeSwitchingGBM(100, [0.08, -0.02], [0.15, 0.4],
    ...                    [[0.95, 0.05], [0.1, 0.9]], steps=8)
    RegimeSwitchingGBMPath(s0=100, K=2, x0_state=0, T=1, steps=8)
    """
    return RegimeSwitchingGBMPath(s0, mu, sigma, transition, x0_state=x0_state, T=T, steps=steps)
