"""The yardstick: the card's published peaks and the least work a launch needs.

A kernel's roofline share is its bound over its measured time.  The bound
of a launch of n samples is the larger of its bytes over the card's HBM
bandwidth and its operations over the card's rates, each pipe on its own
(integer instructions, float32 operations, tensor-core products), since
they run side by side.  The work is counted from the configuration's own
graph, never from what the program lowers it to, so a change to the
program cannot move the yardstick.

The prices are a frozen floor per function: a transcendental or a division
counts 4 float32 operations, an FMA 2, ndtri about 50 (two 9-term Horner
polynomials, a log and a square root), ndtr about 25; a Philox4x32-10 call
is 43 integer instructions and yields four draws.  They are no model of
any kernel's instruction stream.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet; the
# integer rate is 64 INT32 lanes per SM of 132 at the 1980 MHz maximum clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_FLOPS = 67e12  # an FMA counts two
TENSOR_FLOPS = 989e12  # the fastest dense tensor-core rate (bf16 and fp16)

_NDTRI, _NDTR = 50, 25
_DRAW_INTS = 43 / 4

# Per-sample work of one operation: (32-bit integer instructions, float32 flops).
OP_COST = {
    "DRAW": (_DRAW_INTS, 3), "CONSTANT": (0, 0), "STORE": (0, 0),
    "SCORE": (0, _NDTRI), "NDTR": (0, _NDTR + 2),
    "PPF_UNIFORM": (0, 0), "PPF_NORM": (0, _NDTRI), "PPF_EXPON": (0, 4),
    "PPF_LOGNORM": (0, _NDTRI + 5), "PPF_TRIANG": (0, 12),
    "SCORE_NORM": (0, 2), "SCORE_LOGNORM": (0, 7),
    "DIV": (0, 4), "POW": (0, 8), "EXP": (0, 4), "LOG": (0, 4), "SQRT": (0, 4),
    "AFFINE": (0, 2),
}
# The standard variates of the other closed-form families, float32
# operations per sample: a transcendental or a division counts 4, a power
# 8, expm1 14 (its Taylor branch), a wide-range ndtri 100.
_WIDE, _EXPM1 = 100, 14
FAMILY_FLOPS = {
    "truncnorm": 2 * _NDTR + _WIDE + 6, "cauchy": 6, "laplace": 7, "logistic": 9,
    "gumbel_r": 9, "gumbel_l": 9, "rayleigh": 9, "halfnorm": _WIDE + 2, "pareto": 13,
    "weibull_min": 16, "weibull_max": 16, "powerlaw": 12, "loguniform": 19, "arcsine": 6,
    "hypsecant": 11, "fisk": 16, "genpareto": 10 + _EXPM1, "genextreme": 12 + _EXPM1,
    "bernoulli": 2, "geom": 13, "randint": 6, "alpha": _NDTR + _WIDE + 6,
    "bradford": 9 + _EXPM1, "burr": 20 + _EXPM1, "burr12": 20 + _EXPM1, "dweibull": 19,
    "exponpow": 20, "exponweib": 24 + _EXPM1, "fatiguelife": _NDTRI + 10,
    "genhalflogistic": 18, "genlogistic": 12 + _EXPM1, "gibrat": _NDTRI + 4, "gompertz": 12,
    "halfcauchy": 10, "halflogistic": 9, "invweibull": 16, "johnsonsb": _NDTRI + 14,
    "johnsonsu": _NDTRI + 15, "kappa3": 26 + _EXPM1, "laplace_asymmetric": 16,
    "levy": _WIDE + 5, "levy_l": _WIDE + 6, "loglaplace": 14, "lomax": 8 + _EXPM1,
    "mielke": 28 + _EXPM1, "moyal": _WIDE + 6, "powerlognorm": 16 + _EXPM1 + _WIDE,
    "powernorm": 12 + _EXPM1 + _WIDE, "trapezoid": 22, "truncexpon": 5 + _EXPM1,
    "truncpareto": 24, "truncweibull_min": 40, "tukeylambda": 22, "reciprocal": 19,
    "skewcauchy": 16, "kappa4": 16 + 2 * _EXPM1, "crystalball": _NDTR + _WIDE + 45,
}
OP_COST.update({f"PPF_{name.upper()}": (0, flops) for name, flops in FAMILY_FLOPS.items()})
# The first five families' rows take their loc and scale themselves; every
# other family's standard variate is followed by loc + scale * x.
_OWN_AFFINE = ("uniform", "norm", "expon", "lognorm", "triang")
# A correlated variable of these families takes its value from the
# recoloured score in closed form, ppf(ndtr(y)) = loc + scale * y (or
# loc + scale * exp(s * y)); the others through ndtr and their ppf.
_SCORE_LINEAR = {"norm": "SCORE_NORM", "lognorm": "SCORE_LOGNORM"}
# A transform's operation, by the configuration's name of it.
TRANSFORM_OPS = {
    "Add": "ADD", "Multiply": "MUL", "Subtract": "SUB", "Divide": "DIV", "Max": "MAX",
    "Min": "MIN", "Power": "POW", "Exp": "EXP", "Log": "LOG", "Sqrt": "SQRT",
    "Negate": "NEG", "Abs": "ABS", "Square": "SQUARE",
}


def _price(op):
    return OP_COST.get(op, (0, 1))


def k1_cost(config):
    """(integer instructions, float32 flops) per sample of the whole graph
    of ``config``: each distribution's draw and ppf (a correlated one's
    score, its recolouring, K multiply-adds, and its way back), each
    transform's operations (a variadic one of k inputs k - 1 of them)."""
    corr = config.get("correlation")
    correlated = set(corr["variables"]) if corr else set()
    k = len(correlated)
    ints = flops = 0.0
    for node in config["nodes"]:
        if "family" in node:
            family = node["family"]
            parts = ["DRAW"]
            if node["name"] in correlated:
                parts += ["SCORE"]
                flops += 2 * k  # RECOLOR: y = b + A z
                if family in _SCORE_LINEAR:
                    parts += [_SCORE_LINEAR[family]]
                else:
                    parts += ["NDTR", f"PPF_{family.upper()}"]
            else:
                parts += [f"PPF_{family.upper()}"]
            if family not in _OWN_AFFINE and family not in _SCORE_LINEAR:
                parts += ["AFFINE"]
        else:
            op = TRANSFORM_OPS.get(node["op"], node["op"].upper())
            parts = [op] * max(len(node["inputs"]) - 1, 1)
        for part in parts:
            i, f = _price(part)
            ints, flops = ints + i, flops + f
    return ints, flops


def k1_bytes(n):
    """Bytes a launch of n samples must move: the sink's float32 values
    written once (its inputs are the seed and the constants)."""
    return 4 * n


def k2_cost(k):
    """(integer instructions, float32 flops, tensor-core flops) per sample
    of the correlation statistics of k variables: k draws and scores, the
    k sums, and the k(k+1)/2 cross products, two flops each, priced at the
    tensor cores' rate so that no way of forming the same sums reads over
    its bound."""
    return _DRAW_INTS * k, k * (3 + _NDTRI + 1), 2 * (k * (k + 1) // 2)


def k2_bytes(k):
    """The sums' float64 words, written once."""
    return 8 * (k + k * (k + 1) // 2)


def bound(n, nbytes, ints=0.0, flops=0.0, tensor_flops=0.0):
    """(seconds, what binds): the least time for n samples, the larger of
    bytes over bandwidth and the slowest pipe's operations over its rate."""
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S,
        "operations": max(n * ints / INT32_OPS_PER_S, n * flops / FP32_FLOPS,
                          n * tensor_flops / TENSOR_FLOPS),
    }
    by = max(times, key=times.get)
    return times[by], by


def k1_bound(config, n):
    ints, flops = k1_cost(config)
    return bound(n, k1_bytes(n), ints, flops)


def k2_bound(config, n):
    corr = config.get("correlation")
    if not corr:
        return None
    k = len(corr["variables"])
    ints, flops, tensor = k2_cost(k)
    return bound(n, k2_bytes(k), ints, flops, tensor)
