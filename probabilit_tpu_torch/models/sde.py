"""Generic scalar SDE path node: user drift and diffusion, Euler or Milstein.

Port of ``probabilit_tpu/models/sde.py``.  Any scalar Ito diffusion

    dX_t = a(t, X_t) dt + b(t, X_t) dW_t,    X_0 = x0,

with ``a`` and ``b`` plain Python callables of ``(t, x)`` on torch
tensors (``t`` a 0-dim tensor, the step's left endpoint; ``x`` the
``(n,)`` state), elementwise in ``x``; a callable may return a constant,
which broadcasts.  Two schemes:

* ``"euler"``: Euler-Maruyama, strong order 0.5, weak order 1;
* ``"milstein"``: adds ``0.5 b b' (dW^2 - dt)``, strong order 1.  The
  state derivative ``b' = db/dx`` comes from one forward-mode pass of the
  diffusion callable a step (``torch.func.jvp`` with a ones tangent,
  where the JAX package calls ``jax.jvp``), exact because the callable is
  elementwise.

All ``steps`` normal drivers are drawn before the time loop, as one
``(n, steps)`` matrix (a column-keyed generator, or the node's slab in
Brownian-bridge order on an explicit matrix: ``models/processes.py``);
the scheme is a loop over the steps, a few elementwise ops and the two
callables each.  A callable written for the JAX package (``jnp``) fails
on torch tensors with its own error.

>>> sde = SDE(lambda t, x: 1.5 * (0.5 - x), lambda t, x: 0.3, x0=2.0,
...           T=1.0, steps=4)
>>> sde.terminal()
PathFunctional(SDEPath(<lambda>, <lambda>, x0=2, T=1, steps=4, scheme='euler'), 'terminal')
"""

from __future__ import annotations

import torch

from probabilit_tpu_torch.models.processes import PathDistribution, normal, sample_major, time_major

__all__ = ["SDE", "SDEPath"]

_SCHEMES = ("euler", "milstein")


class SDEPath(PathDistribution):
    """Scalar Ito diffusion discretised by Euler-Maruyama or Milstein.

    Unlike the exact families the grid law carries discretisation error
    (weak O(dt), strong O(sqrt(dt)) for Euler; strong O(dt) for Milstein).
    """

    # The parameters live inside the user's closures.
    _param_slots = ()

    def __init__(self, drift, diffusion, x0=0.0, T=1.0, steps=252, scheme="euler"):
        if not callable(drift):
            raise TypeError(f"drift must be callable, got {drift!r}.")
        if not callable(diffusion):
            raise TypeError(f"diffusion must be callable, got {diffusion!r}.")
        if scheme not in _SCHEMES:
            raise ValueError(f"scheme must be one of {_SCHEMES}, got {scheme!r}.")
        self.drift = drift
        self.diffusion = diffusion
        self.x0 = float(x0)
        self.scheme = scheme
        super().__init__(steps, T)

    def __repr__(self):
        dname = getattr(self.drift, "__name__", type(self.drift).__name__)
        bname = getattr(self.diffusion, "__name__", type(self.diffusion).__name__)
        return (
            f"SDEPath({dname}, {bname}, x0={self.x0:g}, T={self.T:g}, "
            f"steps={self.steps}, scheme={self.scheme!r})"
        )

    def _static_signature(self):
        # The callables enter by identity, as in ScalarFunctionTransform;
        # the node keeps both alive.
        return (
            "SDEPath", id(self.drift), id(self.diffusion), self.x0, self.T, self.steps,
            self.scheme,
        )

    def _increments(self, gen, n, dtype):
        return normal(gen, (n, self.steps), dtype)

    def _increments_from_slab(self, slab, dtype):
        return self._bridge_z(slab, dtype)

    def _increments_from_normals(self, z, dtype):
        # The scheme scales the raw normals itself.
        return z

    def _regrid(self, steps):
        return SDEPath(
            self.drift, self.diffusion, x0=self.x0, T=self.T, steps=steps, scheme=self.scheme
        )

    @staticmethod
    def _eval(fn, t, x):
        """A user callable's value as an ``(n,)`` tensor (constants
        broadcast)."""
        v = fn(t, x)
        if isinstance(v, torch.Tensor):
            v = v.to(x.dtype)
        else:
            v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        return torch.broadcast_to(v, x.shape)

    def _path_from_increments(self, z):
        dtype, device = z.dtype, z.device
        dt = torch.tensor(self.T / self.steps, dtype=dtype, device=device)
        sqdt = torch.sqrt(dt)
        half_dt = 0.5 * dt
        ts = torch.arange(self.steps, dtype=dtype, device=device) * dt
        milstein = self.scheme == "milstein"
        x = torch.full((z.shape[0],), self.x0, dtype=dtype, device=device)
        z = time_major(z)
        out = torch.empty_like(z)
        for k in range(self.steps):
            z_k, t = z[k], ts[k]
            a = self._eval(self.drift, t, x)
            if milstein:
                # One forward-mode pass gives b and b' = db/dx (diagonal:
                # the callable is elementwise).
                b, db = torch.func.jvp(
                    lambda xx: self._eval(self.diffusion, t, xx), (x,), (torch.ones_like(x),)
                )
                x = x + a * dt + b * sqdt * z_k + half_dt * b * db * (z_k * z_k - 1.0)
            else:
                b = self._eval(self.diffusion, t, x)
                x = x + a * dt + b * sqdt * z_k
            out[k] = x
        return sample_major(out)


def SDE(drift, diffusion, x0=0.0, T=1.0, steps=252, scheme="euler"):
    """Generic scalar SDE path node; see :class:`SDEPath`.

    >>> ou = SDE(lambda t, x: 1.5 * (0.5 - x), lambda t, x: 0.3, x0=2.0,
    ...          steps=8, scheme="milstein")
    >>> ou
    SDEPath(<lambda>, <lambda>, x0=2, T=1, steps=8, scheme='milstein')
    """
    return SDEPath(drift, diffusion, x0=x0, T=T, steps=steps, scheme=scheme)
