"""Least-squares Monte Carlo for American/Bermudan exercise (LSMC).

Port of ``probabilit_tpu/engine/american.py``.  Prices optimal-stopping
payoffs on any path node (``models/processes.py``, ``levy.py``,
``stochvol.py``, ``sde.py``) with the Longstaff-Schwartz algorithm
(Longstaff & Schwartz 2001, "Valuing American options by simulation"):
backward induction where each exercise date's continuation value is a
polynomial regression of the discounted future cashflow on the current
state, fitted over in-the-money paths.

The paths are time-major, ``(steps, n, .)``, so each date's slice is
contiguous.  The backward induction is a host loop over the ``steps - 1``
interior dates (the JAX package's ``lax.scan``); each date runs on the
device: the payoff, the in-the-money mask, the state standardised over
the in-the-money paths, the monomial basis, the ``B x B`` Gram matrix and
right-hand side in full float32 (TF32 off, as the JAX package pins
float32 matmul precision), the ridge, ``torch.linalg.solve_ex`` (no
wait for the host: the weights are checked once, after the last date)
and the exercise select.  Nothing in the loop reads a value back.

Estimation is two-pass by default: pass 1 fits the per-date regression
weights, pass 2 applies the fitted exercise policy to an independent
sample, which removes the foresight bias of in-sample LSMC.  Multi-factor
nodes regress on their full per-date Markov state (Heston's asset and
variance); ``state="asset"`` keeps the classical single-factor basis.

Seeds: the fit, the evaluation and each evaluation replicate draw from
their own ``_derive_seed`` paths under the run's seed (the JAX package
splits one key and folds the replicate index in), so the port's prices
are the same estimators on other bits.  ``american_greeks`` fits once and
differentiates the evaluation pass with ``torch.autograd`` (the fitted
policy detached).  No kernel lies on this path.

Under a device mesh the paths are drawn on the first device (a
``torch.Generator`` cannot be addressed by row) and split by rows: each
date's Gram matrix and right-hand side are the sums of the shards'
partial products, the solve runs once, and each shard applies the
weights, and later the policy, to its own rows.

>>> import torch
>>> from probabilit_tpu_torch import GeometricBrownianMotion
>>> gbm = GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=50)
>>> res = american_price(gbm, lambda s: torch.clamp(40.0 - s, min=0.0),
...                      rate=0.06, size=2**16, random_state=0)   # doctest: +SKIP
>>> bool(abs(res["price"] - 4.478) < 0.08)   # doctest: +SKIP
True
"""

from __future__ import annotations

import functools
import math
import operator

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine.sampler import resolve_seed
from probabilit_tpu_torch.engine.streaming import _derive_seed
from probabilit_tpu_torch.ops.correlation import _full_float32
from probabilit_tpu_torch.parallel import mesh as _mesh

__all__ = ["american_price", "american_greeks"]

# ``_derive_seed(seed, _STREAM, ...)`` paths of the three samples.
_STREAM = 5
_FIT, _EVALUATE, _REPLICATE = 0, 1, 2


def _monomial_powers(n_states, degree):
    """Exponent tuples of all total-degree-<= ``degree`` monomials.

    One state: ``(0,), (1,), ..., (degree,)``, the classical LSM basis.
    Two states at degree 3: ten terms ``1, s, v, s^2, s v, v^2, ...``.
    """
    out = []

    def rec(prefix, remaining, budget):
        if remaining == 0:
            out.append(tuple(prefix))
            return
        for p in range(budget + 1):
            rec(prefix + [p], remaining - 1, budget - p)

    rec([], n_states, degree)
    out.sort(key=lambda t: (sum(t), tuple(-p for p in t)))
    return tuple(out)


def _ipow(x, p):
    """``x ** p`` for an integer ``p >= 1`` by binary powering, the
    products XLA's ``integer_pow`` forms."""
    acc = None
    while p:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p:
            x = x * x
    return acc


def _basis(x, powers):
    """Monomial features ``(n, B)`` of the standardised ``(n, S)`` state."""
    feats = []
    for pw in powers:
        f = torch.ones_like(x[:, 0])
        for j, p in enumerate(pw):
            if p:
                f = f * _ipow(x[:, j], p)
        feats.append(f)
    return torch.stack(feats, dim=1)


def _resolve_state(node, state):
    """-> (mode tag, feature-select callable or None)."""
    if state in (None, "auto", "joint"):
        return "joint", None
    if state == "asset":
        return "asset", None
    if callable(state):
        return "custom", state
    raise ValueError(
        f"state must be 'auto'/'joint', 'asset', or a callable mapping "
        f"the node's state tuple to feature paths; got {state!r}."
    )


def _sample_states(node, seed, n, dtype, method, mode, state_fn, device=None):
    """(payoff paths (steps, n, P), features (steps, n, S)), time-major.

    ``P = node._payoff_arity`` (1 for scalar path nodes; d for joint
    multi-asset nodes, whose payoff receives one per-asset slice per
    argument).  ``method=None`` draws the node's increments from a
    ``torch.Generator`` seeded ``seed``; ``method="sobol"/...`` drives the
    node through its quantile-slab constructor with the sequence's
    randomisation derived from ``seed``.
    """
    device = config.device() if device is None else device
    if method is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        inc = node._increments(gen, n, dtype)
    else:
        from probabilit_tpu_torch.ops import qmc as _qmc

        q = _qmc.generate(method, seed, n, node._q_width, dtype, device=device)
        inc = node._increments_from_slab(q, dtype)
    states = node._state_paths_from_increments(inc)
    p_arity = getattr(node, "_payoff_arity", 1)
    if state_fn is not None:
        feats = tuple(state_fn(*states))
    elif mode == "asset":
        feats = states[:p_arity]
    else:
        feats = states
    pay = torch.stack([s.T for s in states[:p_arity]], dim=2)
    return pay, torch.stack([f.T for f in feats], dim=2)


def _call_payoff(payoff, p_k):
    """Apply the user payoff to a per-date ``(n, P)`` slice: one positional
    argument per payoff path."""
    return payoff(*(p_k[:, j] for j in range(p_k.shape[1])))


def _shards(x):
    """The time-major ``x``'s row blocks (axis 1) under the active mesh,
    each on its shard's device, or ``[x]`` without one."""
    mesh = _mesh.current_mesh()
    if mesh is None:
        return [x]
    return [b for b in _mesh.split_rows(x, mesh, axis=1) if b.shape[1]]


def _total(parts, device):
    """The shards' partial results summed on ``device`` (one part: itself)."""
    return functools.reduce(operator.add, [p.to(device) for p in parts])


def _standardize(s_ks, itms, device):
    """Per-date ITM mean/std of each state dim (guarded against empty ITM),
    from the shards' partial sums.

    Powers of a zero-mean unit-variance state keep the monomial Gram
    matrix well-conditioned in float32.
    """
    cnt = torch.clamp(_total([itm.sum() for itm in itms], device), min=1.0)
    mu = _total([(s_k * itm[:, None]).sum(dim=0) for s_k, itm in zip(s_ks, itms)], device) / cnt
    parts = []
    for s_k, itm in zip(s_ks, itms):
        dev = s_k - mu.to(s_k.device)[None, :]
        parts.append((itm[:, None] * (dev * dev)).sum(dim=0))
    var = _total(parts, device) / cnt
    sd = torch.sqrt(var + 1e-12)
    return mu, torch.clamp(sd, min=1e-6)


def _fit_weights(pay, feats, payoff, powers, disc, ridge):
    """Backward induction -> per-date ``(weights, means, stds)``, stacked
    in forward date order: ``(steps - 1, B)``, ``(steps - 1, S)`` twice.

    The carry is the value vector "cashflow discounted to the current
    date"; each date regresses it (ITM-weighted) on the basis of the
    per-date standardised state, then replaces it where immediate exercise
    beats the fitted continuation.  The terminal date exercises
    intrinsically and seeds the carry.  Weights that are not finite on a
    date with in-the-money paths raise ``FloatingPointError`` (one host
    read, after the loop); a date without one has no regression, and its
    weights are NaN, so that no path exercises there.

    Under a device mesh the paths are split by rows: each date's moments,
    Gram matrix and right-hand side are the sums of the shards' partial
    products on the first device, the solve runs once there, and each
    shard applies the weights to its own rows.
    """
    dtype, device = pay.dtype, pay.device
    nb = len(powers)
    pays, feat_parts = _shards(pay), _shards(feats)
    vs = [_call_payoff(payoff, p[-1]) for p in pays]
    eye = torch.eye(nb, dtype=dtype, device=device)
    ws, mus, sds, counts = [], [], [], []
    with _full_float32():
        for k in range(pay.shape[0] - 2, -1, -1):
            vs = [disc * v for v in vs]
            exs = [_call_payoff(payoff, p[k]) for p in pays]
            itms = [(ex > 0).to(dtype) for ex in exs]
            mu, sd = _standardize([f[k] for f in feat_parts], itms, device)
            phis = [
                _basis((f[k] - mu.to(f.device)[None, :]) / sd.to(f.device)[None, :], powers)
                for f in feat_parts
            ]
            phiws = [phi * itm[:, None] for phi, itm in zip(phis, itms)]
            g = _total([phiw.T @ phi for phiw, phi in zip(phiws, phis)], device)
            g = g + (ridge * torch.trace(g) / nb) * eye
            b = _total([phiw.T @ (v * itm) for phiw, v, itm in zip(phiws, vs, itms)], device)
            w = torch.linalg.solve_ex(g, b)[0]
            count = _total([itm.sum() for itm in itms], device)
            w = torch.where(count > 0, w, torch.full_like(w, math.nan))
            vs = [
                torch.where((itm > 0) & (ex > phi @ w.to(phi.device)), ex, v)
                for phi, itm, ex, v in zip(phis, itms, exs, vs)
            ]
            ws.append(w)
            mus.append(mu)
            sds.append(sd)
            counts.append(count)
    ws, mus, sds = (torch.stack(x[::-1]) for x in (ws, mus, sds))
    bad = ~torch.isfinite(ws).all(dim=1) & (torch.stack(counts[::-1]) > 0)
    if bool(bad.any()):
        dates = torch.nonzero(bad).flatten().tolist()
        raise FloatingPointError(
            f"Non-finite LSMC regression weights on exercise dates {dates}."
        )
    return ws, mus, sds


def _apply_policy(pay, feats, payoff, powers, disc, fit):
    """Forward pass: exercise the fitted policy on the given paths.
    Returns ``(value, stopped)``, each ``(n,)``.  Under a device mesh each
    shard runs its own rows; the results are gathered on the first
    device."""
    mesh = _mesh.current_mesh()
    if mesh is None:
        return _apply_policy_rows(pay, feats, payoff, powers, disc, fit)
    parts = [
        _apply_policy_rows(p, f, payoff, powers, disc, fit)
        for p, f in zip(_shards(pay), _shards(feats))
    ]
    return _mesh.gather_rows(parts, [p[0].shape[0] for p in parts], mesh.devices[0])


def _apply_policy_rows(pay, feats, payoff, powers, disc, fit):
    n, dtype, device = pay.shape[1], pay.dtype, pay.device
    ws, mus, sds = (x.to(device) for x in fit)
    if isinstance(disc, torch.Tensor):
        disc = disc.to(device)
    stopped = torch.zeros((n,), dtype=torch.bool, device=device)
    value = torch.zeros((n,), dtype=dtype, device=device)
    df = torch.as_tensor(disc, dtype=dtype, device=device)
    with _full_float32():
        for k in range(pay.shape[0] - 1):
            ex = _call_payoff(payoff, pay[k])
            phi = _basis((feats[k] - mus[k][None, :]) / sds[k][None, :], powers)
            cont = phi @ ws[k]
            take = (~stopped) & (ex > 0) & (ex > cont)
            value = torch.where(take, df * ex, value)
            stopped = stopped | take
            df = df * disc
    # Unexercised paths cash the terminal intrinsic value.
    value = torch.where(stopped, value, df * _call_payoff(payoff, pay[-1]))
    return value, stopped


def _validate_common(node, payoff, degree, size, method):
    if method is not None and str(method).lower().strip() not in (
        "sobol",
        "halton",
        "lhs",
        "antithetic",
    ):
        raise ValueError(
            "method must be None, 'sobol', 'halton', 'lhs' or "
            f"'antithetic', got {method!r}."
        )
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}.")
    if size < 2 * (degree + 1):
        raise ValueError(f"size={size} is too small for degree {degree}.")
    if node.steps < 2:
        raise ValueError("American exercise needs a grid with steps >= 2.")


def _check_replicates(replicates):
    reps = int(replicates)
    if reps < 2:
        raise ValueError(
            f"replicates must be >= 2 (got {reps}): a single "
            "evaluation sample has no between-replicate spread."
        )
    return reps


def _intrinsic0(node, payoff, dtype, device):
    """The payoff at t = 0: one argument per payoff path (a joint node
    carries a (d,) s0 vector, one t = 0 level per asset)."""
    x0 = None
    for attr in ("s0", "x0", "v0"):
        x0 = getattr(node, attr, None)
        if x0 is not None:
            break
    p_arity = getattr(node, "_payoff_arity", 1)
    if x0 is None:
        x0_vals = [0.0] * p_arity
    else:
        x0_vals = list(np.ravel(np.asarray(x0, np.float64)))[:p_arity]
    args = [torch.full((1,), float(v), dtype=dtype, device=device) for v in x0_vals]
    return float(payoff(*args)[0])


def _seeds(random_state):
    seed = resolve_seed(random_state)
    return _derive_seed(seed, _STREAM, _FIT), seed


def _eval_seed(seed, replicate=None):
    if replicate is None:
        return _derive_seed(seed, _STREAM, _EVALUATE)
    return _derive_seed(seed, _STREAM, _REPLICATE, replicate)


def american_price(
    node,
    payoff,
    *,
    rate=0.0,
    size=1 << 17,
    degree=3,
    random_state=0,
    two_pass=True,
    ridge=1e-6,
    method=None,
    state="auto",
    replicates=None,
):
    """Longstaff-Schwartz price of ``payoff`` exercisable on the grid.

    ``node`` is any path node (its ``steps`` grid dates are the exercise
    dates); ``payoff`` maps a grid slice of the state to intrinsic value
    with torch ops (e.g. ``lambda s: torch.clamp(K - s, min=0.0)``).
    Joint multi-asset nodes (``CorrelatedGBM(...)[0].joint`` or the
    ``CorrelatedGBMPaths``/``CorrelatedMertonPaths``/
    ``CorrelatedHestonPaths`` node itself) pass one per-asset slice per
    argument, and the regression conditions on the full joint state.
    ``rate`` is the continuously-compounded discount rate: price a
    risk-neutral model by giving the node drift ``rate``.

    ``two_pass=True`` (default) fits on one sample and applies the fitted
    policy to an independent one (a foresight-free lower bound with a
    valid ``se``); ``two_pass=False`` reports the in-sample estimate.
    ``state`` is ``"auto"``/``"joint"`` (the node's full Markov state),
    ``"asset"``, or a callable mapping the node's state paths (each
    ``(n, steps)``) to a tuple of feature paths.  ``method="sobol"`` (or
    halton/lhs/antithetic) drives the paths with a low-discrepancy
    sequence; the fit and evaluation get independent randomisations.
    ``replicates=R`` (two-pass only) applies the one fitted policy to R
    independently seeded evaluation samples: ``price`` is their average
    and ``se`` the between-replicate standard error.

    Returns a dict: ``price`` (including immediate exercise at t = 0),
    ``se`` (of the sample the price is computed from),
    ``exercise_fraction`` (paths stopped before T) and ``weights``
    (per-date regression coefficients, forward order).
    """
    _validate_common(node, payoff, degree, size, method)
    mode, state_fn = _resolve_state(node, state)
    dtype, device = config.float_dtype(), config.device()
    disc = math.exp(-float(rate) * node.T / node.steps)
    method = None if method is None else str(method).lower().strip()
    if replicates is not None:
        reps = _check_replicates(replicates)
        if not two_pass:
            raise ValueError(
                "replicates= needs two_pass=True: it replicates the "
                "policy-evaluation pass (the in-sample estimate has no "
                "independent evaluation sample to replicate)."
            )
    fit_seed, seed = _seeds(random_state)

    def draw(s):
        return _sample_states(node, s, size, dtype, method, mode, state_fn, device)

    pay, feats = draw(fit_seed)
    powers = _monomial_powers(feats.shape[2], degree)
    fitted = _fit_weights(pay, feats, payoff, powers, disc, ridge)
    if two_pass:
        del pay, feats
        seeds = ([_eval_seed(seed)] if replicates is None
                 else [_eval_seed(seed, r) for r in range(reps)])
        runs = [_apply_policy(*draw(s), payoff, powers, disc, fitted) for s in seeds]
    else:
        runs = [_apply_policy(pay, feats, payoff, powers, disc, fitted)]

    intrinsic0 = _intrinsic0(node, payoff, dtype, device)
    stopped_share = float(torch.stack([s_.double().mean() for _, s_ in runs]).mean())
    if replicates is None:
        v64 = runs[0][0].double()
        mean = float(v64.mean())
        se = float(v64.std() / math.sqrt(size))
    else:
        rep_means = torch.stack([v.double().mean() for v, _ in runs]).cpu().numpy()
        mean = float(rep_means.mean())
        se = float(rep_means.std(ddof=1) / math.sqrt(reps))
    out = {
        "price": max(mean, intrinsic0),
        "se": se,
        "exercise_fraction": stopped_share,
        "weights": fitted[0].cpu().numpy(),
    }
    if replicates is not None:
        out["replicates"] = reps
    return out


def american_greeks(
    node,
    payoff,
    *,
    rate=0.0,
    wrt=None,
    size=1 << 17,
    degree=3,
    random_state=0,
    ridge=1e-6,
    method=None,
    state="auto",
    replicates=None,
):
    """Pathwise Greeks of the two-pass LSMC price under a frozen policy.

    Fits the exercise policy at the current parameters (pass 1, as
    ``american_price``), detaches it, and differentiates the second-pass
    value (the fitted policy applied to an independent sample) with
    ``torch.autograd`` with respect to the node's differentiable
    parameters and the discount ``rate``.  By the envelope argument the
    price of an optimally exercised claim is first-order insensitive to
    the boundary, so the frozen-policy Greeks are consistent.

    ``wrt`` defaults to every slot of ``node._param_slots`` plus
    ``"rate"``.  Returns ``{"price", "se", slot: gradient, ...}``, where
    ``price`` is the two-pass mean (no max with immediate exercise) and
    ``se`` the standard error of the same sample.  ``replicates=R`` runs R
    independently seeded evaluation passes under the one policy: each
    Greek gains a ``"<slot>_sem"``, ``price`` and the Greeks become
    replicate averages and ``se`` the between-replicate standard error.
    A gradient that is not finite raises ``FloatingPointError``.
    """
    from probabilit_tpu_torch.engine.sensitivity import _read_slot, _swapped

    _validate_common(node, payoff, degree, size, method)
    if replicates is not None:
        _check_replicates(replicates)
    mode, state_fn = _resolve_state(node, state)
    slots = list(getattr(node, "_param_slots", ()))
    if wrt is None:
        wrt = slots + ["rate"]
    wrt = list(wrt)
    if not wrt:
        raise ValueError("wrt is empty.")
    for s in wrt:
        if s != "rate" and s not in slots:
            raise ValueError(
                f"{type(node).__name__} has no differentiable parameter "
                f"{s!r}; available: {slots + ['rate']}."
            )
    dtype, device = config.float_dtype(), config.device()
    dt = node.T / node.steps
    disc = math.exp(-float(rate) * dt)
    method = None if method is None else str(method).lower().strip()
    fit_seed, seed = _seeds(random_state)

    pay, feats = _sample_states(node, fit_seed, size, dtype, method, mode, state_fn, device)
    powers = _monomial_powers(feats.shape[2], degree)
    # Drawn and fitted before any slot is a leaf: the policy holds no graph.
    fitted = _fit_weights(pay, feats, payoff, powers, disc, ridge)
    del pay, feats

    pairs = [(node, s) for s in wrt if s != "rate"]
    slot_index = [i for i, s in enumerate(wrt) if s != "rate"]
    theta0 = [float(rate) if s == "rate" else float(_read_slot(node, s)) for s in wrt]

    def value_and_grad(eval_seed):
        """(mean, se, gradient...) of one evaluation sample, on the device."""
        theta = torch.tensor(theta0, dtype=dtype, device=device, requires_grad=True)
        if "rate" in wrt:
            rate_t = theta[wrt.index("rate")]
        else:
            rate_t = torch.tensor(float(rate), dtype=dtype, device=device)

        def evaluate():
            pay, feats = _sample_states(node, eval_seed, size, dtype, method, mode, state_fn,
                                        device)
            disc_t = torch.exp(-rate_t * torch.tensor(dt, dtype=dtype, device=device))
            return _apply_policy(pay, feats, payoff, powers, disc_t, fitted)[0]

        value = _swapped(pairs, theta[slot_index], evaluate)
        mean = value.mean()
        (grad,) = torch.autograd.grad(mean, theta, allow_unused=True)
        grad = torch.zeros_like(theta) if grad is None else grad
        se = value.detach().std() / math.sqrt(value.shape[0])
        return torch.cat([mean.detach().reshape(1), se.reshape(1), grad.detach()])

    if replicates is None:
        row = value_and_grad(_eval_seed(seed)).double().cpu().numpy()
        grads = row[2:]
        if not np.all(np.isfinite(grads)):
            raise FloatingPointError(f"Non-finite American greeks: {grads.tolist()}.")
        out = {"price": float(row[0]), "se": float(row[1])}
        for s, g in zip(wrt, grads):
            out[s] = float(g)
        return out
    reps = int(replicates)
    rows = torch.stack([value_and_grad(_eval_seed(seed, r)) for r in range(reps)])
    rows = rows.double().cpu().numpy()
    vals, gs = rows[:, 0], rows[:, 2:]
    if not np.all(np.isfinite(gs)):
        raise FloatingPointError(f"Non-finite American greeks: {gs.tolist()}.")
    out = {
        "price": float(vals.mean()),
        "se": float(vals.std(ddof=1) / math.sqrt(reps)),
        "replicates": reps,
    }
    gmean = gs.mean(axis=0)
    gsem = gs.std(axis=0, ddof=1) / math.sqrt(reps)
    for s, g, e in zip(wrt, gmean, gsem):
        out[s] = float(g)
        out[s + "_sem"] = float(e)
    return out
