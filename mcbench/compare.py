"""The numbers that decide ``correct``: the program's answers against the
plain reference's, each as one number that has a limit of its own
(``limits/<cell>.json``).

A streamed call's answer is its statistics:

* ``mean_gap_sem``: |mean - reference mean| in the reference's standard
  errors;
* ``spread_gap``: the larger relative gap of ``std`` and of ``sem``;
* ``extremes_gap_std``: the larger gap of ``min`` and of ``max``, in the
  reference's standard deviations;
* ``tails_gap_std``: the largest gap of a quantile or a CVaR, in the
  reference's standard deviations (mixes that ask for them).

A one-shot call's answer is its samples, compared one by one in blocks:

* ``sample_gap_mean_std``: the mean |x - reference x|, in the reference's
  standard deviations;
* ``sample_gap_max_std``: the largest |x - reference x|, likewise.
"""

from __future__ import annotations

import math

import torch


def stream_numbers(program, ref, traffic):
    """The numbers of one streamed call: dicts of statistics."""
    std, sem = ref["std"], ref["sem"]
    out = {
        "mean_gap_sem": abs(program["mean"] - ref["mean"]) / sem,
        "spread_gap": max(abs(program["std"] / std - 1.0), abs(program["sem"] / sem - 1.0)),
        "extremes_gap_std": max(abs(program["min"] - ref["min"]),
                                abs(program["max"] - ref["max"])) / std,
    }
    keys = [f"q{q:g}" for q in traffic["options"].get("quantiles", ())]
    keys += [f"cvar{q:g}" for q in traffic["options"].get("cvar", ())]
    if keys:
        out["tails_gap_std"] = float(max(abs(program[k] - ref[k]) for k in keys) / std)
    if program.get("n") != ref["n"]:
        out["spread_gap"] = math.inf  # a count that differs: a different answer
    return out


class SampleGap:
    """Running gaps of a one-shot call's samples against the reference's."""

    def __init__(self):
        self.n = 0
        self.abs_sum = self.abs_max = 0.0
        self.ref_sum = self.ref_sq = 0.0

    def add(self, program, ref):
        d = (program.to(torch.float64) - ref.to(torch.float64)).abs()
        self.n += d.numel()
        self.abs_sum += float(d.sum())
        self.abs_max = max(self.abs_max, float(d.max()))
        r = ref.to(torch.float64)
        self.ref_sum += float(r.sum())
        self.ref_sq += float((r * r).sum())

    def numbers(self):
        mean = self.ref_sum / self.n
        std = math.sqrt(max(self.ref_sq / self.n - mean * mean, 0.0))
        return {"sample_gap_mean_std": self.abs_sum / self.n / std,
                "sample_gap_max_std": self.abs_max / std}


def worst(readings):
    """Per number, the largest of several calls' readings."""
    out = {}
    for numbers in readings:
        for k, v in numbers.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(numbers, limits):
    """(correct, [(name, number, limit)]): every number within its limit.
    A number the limits do not name, or a NaN, is not correct."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = bool(rows) and all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows
