"""Derive the polynomial coefficients of ``csrc/fast_math.cuh``.

    python3 tools/fast_math_fit.py

Fits, by Lawson's iteratively reweighted least squares on a dense grid
(which converges to the minimax polynomial), each reduced function of the
header for its relative error:

* ``log1p_reduced``: log(1 + f) = f + f^2 P(f), f in [-1/3, 1/3], P of
  degree 8 (its constant term rounds to -1/2 exactly);
* ``tan_reduced``: tan r = r + r^3 P(r^2), |r| <= pi/4, P of degree 5;
* ``sin_fast``: sin x = x + x^3 P(x^2), |x| <= pi/2, P of degree 3.

Prints, per function, the float32 coefficients (highest degree first, as
the header's Horner steps take them), the fit's relative error in exact
arithmetic, and the largest relative error of the float32 evaluation
(float32 Horner steps, no FMA) on a finer grid, in units of 2^-24.  Runs
on the CPU with numpy alone.
"""

from __future__ import annotations

import json

import numpy as np


def lawson(x, y, w, degree, iterations=300):
    """Coefficients (lowest degree first) minimising max |w (y - p(x))|."""
    vander = np.vander(x, degree + 1, increasing=True)
    weights = np.ones_like(x) / len(x)
    for _ in range(iterations):
        root = np.sqrt(weights) * w
        c, *_ = np.linalg.lstsq(vander * root[:, None], y * root, rcond=None)
        err = np.abs(w * (y - vander @ c))
        weights = weights * err
        weights /= weights.sum()
    return c, err.max()


def horner32(c, x):
    p = np.full_like(x, np.float32(c[-1]))
    for ck in c[-2::-1]:
        p = np.float32(p * x + np.float32(ck))
    return p


def main():
    n = 20001
    f = np.linspace(-1 / 3, 1 / 3, n)
    f = f[np.abs(f) > 1e-6]
    c, fit = lawson(f, (np.log1p(f) - f) / f**2, f**2 / np.abs(np.log1p(f)), 8)
    c = np.float32(c)
    ff = np.float32(np.linspace(-1 / 3, 1 / 3, 200001))
    ff = ff[ff != 0]
    got = np.float32(ff + np.float32(ff * ff) * horner32(c, ff))
    want = np.log1p(ff.astype(np.float64))
    report = {"log1p_reduced": (c, fit, np.abs(got - want) / np.abs(want))}

    for name, top, degree, fn in (("tan_reduced", np.pi / 4, 5, np.tan),
                                  ("sin_fast", np.pi / 2, 3, np.sin)):
        r = np.linspace(1e-4, top, n)
        c, fit = lawson(r * r, (fn(r) - r) / r**3, r**3 / np.abs(fn(r)), degree)
        c = np.float32(c)
        rr = np.float32(np.linspace(1e-6, top, 200001))
        got = np.float32(rr + np.float32(rr * np.float32(rr * rr)) * horner32(c, np.float32(rr * rr)))
        want = fn(rr.astype(np.float64))
        report[name] = (c, fit, np.abs(got - want) / np.abs(want))

    for name, (c, fit, rel) in report.items():
        print(json.dumps({"function": name,
                          "coefficients_highest_first": [repr(float(v)) for v in c[::-1]],
                          "fit_relative_error": float(fit),
                          "float32_error_units_of_2^-24": float(rel.max() / 2.0**-24)}))


if __name__ == "__main__":
    main()
