"""Graph inspection: pair-plotting and tree rendering.

Port of ``probabilit_tpu/inspection.py``: the same rendering format and
sampling defaults.  The plotting dependencies (seaborn, pandas) are
imported when ``plot`` is called, so the compute path needs neither.
"""

from __future__ import annotations

from numbers import Number

import numpy as np

from probabilit_tpu_torch.models.distributions import Distribution  # noqa: F401  (importable here, as in the JAX package)
from probabilit_tpu_torch.models.graph import NoOp, Transform

__all__ = ["plot", "treeprint"]


def plot(*variables, corr=None, sample_kwargs=None, **kwargs):
    """Pairplot one or more variables, sampling them if needed.

    The variables are detached first (wrapped in a throwaway sink and
    deep-copied) so the caller's graph is never mutated.  Unsampled
    variables are drawn with ``size=999, random_state=0`` unless
    ``sample_kwargs`` overrides; passing ``corr`` (a matrix, or a scalar
    for exactly two variables) induces that correlation before sampling.
    Extra keyword arguments go to ``seaborn.pairplot``.
    """
    import pandas as pd
    import seaborn

    for var in variables:
        if getattr(var, "_vector_valued", False):
            raise ValueError(
                f"Cannot pairplot vector-valued node {var!r}; plot scalar "
                "marginals/functionals of it instead (e.g. path.terminal())."
            )
    detached_sink = NoOp(*variables).copy()
    variables = detached_sink.parents

    n_sampled = sum(hasattr(v, "samples_") for v in variables)
    if 0 < n_sampled < len(variables):
        raise ValueError("Either all variables must be sampled, or none.")

    must_sample = n_sampled == 0 or corr is not None or sample_kwargs is not None
    if must_sample:
        if corr is not None:
            if isinstance(corr, Number) and len(variables) == 2:
                corr = np.array([[1.0, corr], [corr, 1.0]])
            detached_sink.correlate(*variables, corr_mat=corr)
        options = dict(size=999, random_state=0)
        options.update(sample_kwargs or {})
        detached_sink.sample(**options)

    frame = pd.DataFrame()
    for i, var in enumerate(variables, start=1):
        samples = var.samples_
        frame[f"var_{i}"] = samples.cpu().numpy() if hasattr(samples, "cpu") else np.asarray(samples)
    return seaborn.pairplot(frame, **kwargs)


def _node_label(node):
    """Transforms render as their class name, everything else via repr."""
    return type(node).__name__ if isinstance(node, Transform) else str(node)


def treeprint(node):
    """Render a computational graph as a box-drawing tree.

    >>> from probabilit_tpu_torch.models.distributions import Distribution
    >>> scale = Distribution("expon")
    >>> a = Distribution("norm", loc=1, scale=scale)
    >>> treeprint(a + scale - scale**2)
    Subtract
       ├──Add
       │  ├──Distribution("norm", loc=1, scale=Distribution("expon"))
       │  │  └──Distribution("expon")
       │  └──Distribution("expon")
       └──Power
          ├──Distribution("expon")
          └──Constant(2)
    """
    lines = []
    # An explicit preorder stack: graphs are routinely deeper than Python's
    # recursion limit.
    stack = [(node, "", "")]
    while stack:
        n, indent, connector = stack.pop()
        lines.append(indent + connector + _node_label(n))
        children = list(n.get_parents())
        if not children:
            continue
        # A node drawn on a "last branch" (or the root) contributes blank
        # indentation below itself; a middle branch keeps its pipe running.
        deeper = indent + ("│  " if connector == "├──" else "   ")
        entries = [(child, deeper, "├──") for child in children[:-1]]
        entries.append((children[-1], deeper, "└──"))
        stack.extend(reversed(entries))
    print("\n".join(lines))
