"""CUDA megakernel executor: the whole graph in one generated kernel.

The port's counterpart of ``probabilit_tpu/engine/pallas_exec.py``.  The
TPU kernel is specialised per graph by tracing ``Node._emit`` inside
Pallas; here ``lower`` turns the plan into a *tape* and ``generate`` turns
the tape into the CUDA C++ text of one kernel, which ``_build.py`` compiles
with nvcc at the graph's first run and caches by the text (a few seconds,
once per graph structure and machine, as a ``jit`` would cost).  A tape is

* a value-numbered ``program``: rows ``(opcode, dst, a, b, c, d)``, one
  value per row, which the generator writes out as straight-line code
  (every value a named ``const`` of its kind, so the compiler allocates
  registers and nothing is indexed at run time);
* ``consts``: the immediates of its ``LOADK`` rows, each a Python float
  (a float32 value), int (an int32) or bool.  They reach the kernel as a
  by-value parameter block of 32-bit words (a float's bits, an int's two's
  complement), not as text, so graphs that differ only in their
  constants share one build;
* for the plain twin, the same rows mapped onto slots by liveness
  (``code``, ``int32 (n_instr, 6)``) with a ``float64 (n_instr,)``
  immediate, exact for every float32 and int32 constant.

Every value has a kind, as ``jnp`` types the JAX package's nodes: ``b``
(bool), ``i`` (int32) or ``f`` (float32), ordered b < i < f.  A constant
takes the kind of its Python value, a draw, a ppf, a table row or a
recolour row is ``f``, and a transform takes the kind the port's plain
executor gives it (``value_kind``, the one place the tape is typed).  A
row computes in its own kind (a comparison in the larger of its
operands'), and an operand of another kind is converted where it is read;
``STORE`` writes float32, as the TPU kernel casts at its store.

Opcodes: ``DRAW`` (one uniform column from Philox4x32-10), ``LOADK``, one
per ppf family (parameters are values, so Node-valued parameters work),
three table rows (``TABLE_CDF``, ``TABLE_DISCRETE``, ``TABLE_INTERP``, see
below), one per transform (variadic chains fold left, as
``functools.reduce`` does), ``TO_FLOAT`` (an ``Avg`` operand that is
not float, which ``Avg`` converts before it adds), and ``STORE k``.  A
``NoOp`` inside the graph has no value and no row: a row that reads one
raises the exception the plain executor raises there.  A row holds four operands,
so a family is a row that computes its standard variate from
``(q, shapes)`` (truncnorm,
beta, burr and their kind have two shapes, truncweibull_min three) and
an ``AFFINE`` row ``loc + scale * x`` (``ADD`` for the discrete
families, which have no scale).  The hand-written bodies of the ops live in
``csrc/graph_ops.cuh``, ``csrc/ppf_ops.cuh``, ``csrc/special_ops.cuh``
``csrc/sampling_math.cuh``, ``csrc/table_ops.cuh`` and
``csrc/newton_ops.cuh``; the generated text is those includes, a
grid-stride loop and one line per row and lane (a tape with Newton
families adds the Newton tier's solve to each turn, ``generate``).

Table nodes (the TPU kernel's table branch, ``pallas_exec.py:217-439``):
a static discrete family (``poisson``, ``binom``, ``nbinom`` and scipy's
other discrete families with numeric parameters, from a float32 CDF table
trimmed to the reachable quantiles, ``trimmed_cdf_table``), a numeric
``DiscreteDistribution``, a ``CumulativeDistribution`` and a linear
``EmpiricalDistribution`` of at most ``TABLE_MAX`` entries each.  Their
data lives in ``Tape.tables``, one float32 array, every table padded to a
multiple of four floats; a table row's operands are its quantile and two
literals, the table's offset and its count of boundaries.  After the
tables, ``Tape.tables`` holds each table's guide (``table_guide``: M
32-bit words, for cell ``floor(q M)`` the start of a window of
``GUIDE_WINDOW`` boundaries that holds the cell), M a power of two from
the tape's structure (``guide_cells``: at least four times the table's
intervals, within the shared memory the tape leaves; none below
``GUIDE_MIN_BOUNDARIES``; ``Tape.guides``).  Each block copies the tables
into dynamic shared memory, and each lane reads its cell's word and
searches that window (``csrc/table_ops.cuh``): three loads for most lanes
where the TPU kernel's select tree evaluates all n (a crowded cell's
lanes, and a table without a guide, run the full binary search).
Offsets, counts, M and the window are part of the text; the values are
not, so graphs whose tables differ only in their values share one build.

Random bits: sample ``i`` (the global index, ``start`` + row) of column
``c`` is word ``i & 3`` of Philox4x32-10 at counter
``(g mod 2^32, g >> 32, c, 0)``, ``g = i >> 2``, under the two seed words:
one call serves four consecutive samples, and a thread of either kernel
owns whole groups of four.  The stream depends on the seed and ``i`` only,
so a streamed block that starts at ``b * B`` draws rows ``b * B ..`` of
the seed's one stream, for any ``start`` and ``n`` (a launch masks its
partial first and last group).

Correlated graphs (sort-free Gaussian-copula Iman-Conover, as the TPU
kernel's recolour branch) add ``SCORE k`` (z_k = ndtri_fast of a drawn
column, a named register like any value), ``RECOLOR i``
(y_i = b_i + sum_j A_ij z_j, K unrolled multiply-adds), ``SCORE_NORM`` /
``SCORE_LOGNORM`` (``ppf(ndtr(y))`` in closed form) and ``NDTR``
(``clamp_open_unit(ndtr_fast(y))`` into the variable's own ppf).  The
recolour transform ``(A, b)`` comes from a second kernel,
``csrc/corr_stats.cu``, over the same Philox bits: ``recolor_transform``
launches it, reduces its per-block partials in float64 and solves the
K x K system in float64, on the host (``solve_recolor``, one sync) or on
the same device (``solve_recolor_device``, no sync), as its caller asks.

``run`` and ``corr_stats`` are the wrappers: on tensors that lie on the
CPU they use the plain versions (``run_reference``,
``corr_stats_reference``); on CUDA tensors they build (once) and launch
the kernels, counting the launches in ``LAUNCHES`` and ``STATS_LAUNCHES``,
or raise.  ``run_reference`` is ``philox_uniforms`` (the same random bits
as the kernel) followed by ``run_tape`` (the same tape, interpreted with
PyTorch ops on float32).

``block_fold`` launches ``csrc/block_fold.cu``, a streamed estimate's
fold of one block into its packed float64 carry, and counts its launches
in ``FOLD_LAUNCHES``; it takes CUDA tensors only.  Its plain twin is
``streaming._block_moments`` followed by ``streaming._merge``, which
``streaming._estimate_carry`` runs for a block on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import inspect
import itertools
import numbers
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.models import graph as _graph
from probabilit_tpu_torch.models.distributions import (
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
)
from probabilit_tpu_torch.ops import correlation as _correlation
from probabilit_tpu_torch.ops import philox as _philox
from probabilit_tpu_torch.ops import ppf as _ppf
from probabilit_tpu_torch.ops import special as _special
from probabilit_tpu_torch.ops.qmc import clamp_open_unit
from probabilit_tpu_torch.utils import profiling as _profiling

__all__ = [
    "LAUNCHES",
    "STATS_LAUNCHES",
    "FOLD_LAUNCHES",
    "TABLE_MAX",
    "supports",
    "const_kind",
    "value_kind",
    "program_kinds",
    "trimmed_cdf_table",
    "environment_issue",
    "keep_order",
    "lower",
    "lowered",
    "generate",
    "seed_words",
    "philox_uniforms",
    "run_tape",
    "run_program",
    "run_reference",
    "run",
    "corr_stats_reference",
    "corr_stats",
    "solve_recolor",
    "solve_recolor_device",
    "recolor_transform",
    "PACKED_FIELDS",
    "pack_moments",
    "unpack_moments",
    "fold_scratch",
    "block_fold",
]

# Launches of the megakernel by ``run`` and of the statistics kernel by
# ``corr_stats``.
LAUNCHES = 0
STATS_LAUNCHES = 0
# Launches of the fold kernel by ``block_fold``.
FOLD_LAUNCHES = 0

# What a tape may hold.  MAX_KEEP and MAX_CORR_K are pallas_exec.supports'
# 16 outputs and 16 correlated variables (MAX_CORR_K equals kMaxCorr in
# csrc/corr_stats.cu).  MAX_INSTR bounds the generated kernel's text, four
# lanes of straight-line code a row, so its build time and instruction
# footprint; MAX_CONSTS the by-value parameter block, inside the 4 KB a
# kernel's parameters may take.  MAX_SLOTS binds the plain twin's slot
# file only: the generated kernel's values are the compiler's registers.
MAX_SLOTS = 64
MAX_INSTR = 1024
MAX_CONSTS = 896
MAX_KEEP = 16
MAX_CORR_K = 16
LANES = 4  # samples per Philox call, and per thread and loop turn
_THREADS = 256
_TILE = _THREADS * LANES  # samples of one turn of a block's loop
_HEADERS = (
    "sampling_math.cuh", "special_ops.cuh", "fast_math.cuh", "ppf_ops.cuh", "graph_ops.cuh",
    "table_ops.cuh", "newton_ops.cuh",
)
# The Newton tier (csrc/newton_ops.cuh): a block solves the quantiles of
# a turn together, one float per Newton row and sample in shared memory.
# A turn of a tape with R Newton rows covers max(1, NEWTON_SLOTS // R)
# groups a thread, as shared memory allows: about 12 K quantiles and 48 KB
# a block, so that four blocks of 256 threads share an SM.
NEWTON_SLOTS = 12

# pallas_exec._TABLE_MAX: the most entries a table node may have (knots of
# a trimmed CDF table, values of a Discrete, points of a Cumulative or an
# Empirical).  MAX_SHARED_BYTES is what one block of an H100 may hold in
# shared memory; the tables of one tape, beside the recolour arrays, must
# fit in it.  The TPU kernel has no such total cap (ROADMAP C).
TABLE_MAX = 512
MAX_SHARED_BYTES = 232_448
# The table guides (csrc/table_ops.cuh) take only the shared memory a tape
# leaves once its tables, recolour arrays and Newton tier have theirs: a
# guide has the smallest power of two of cells at least GUIDE_SPREAD times
# the table's NB + 1 intervals, at most GUIDE_MAX_CELLS, and guides shrink
# (``guide_cells``) to fit MAX_SHARED_BYTES and, where four blocks of the
# tape without guides share an SM (SM_SHARED_BYTES, 1 KB of it reserved per
# block), to keep four.  A cell of at most GUIDE_WINDOW boundaries is
# searched in a window of that many.  A table of fewer than
# GUIDE_MIN_BOUNDARIES boundaries (a full search of at most four loads)
# keeps the full search.  Spread 4, window 2 and tables from 9 boundaries
# measured the fastest of spreads 2 and 4, windows 1 to 8 and tables from
# 3, 9 or 17 boundaries on an H100 (PERF.md, the table branch finding).
GUIDE_SPREAD = 4
GUIDE_MAX_CELLS = 2048
GUIDE_WINDOW = 2
GUIDE_MIN_BOUNDARIES = 9
SM_SHARED_BYTES = 233_472

# Score-linear families: ppf(ndtr(y)) has a closed form in the score y.
_SCORE_OPS = {"norm": "SCORE_NORM", "lognorm": "SCORE_LOGNORM"}

# The TPU kernel's closed-form whitelist (pallas_exec._SAFE_FAMILIES).  It
# leaves out on purpose the families whose bodies it cannot lower: anglit,
# wrapcauchy, the safeguarded-Newton tier (semicircular, cosine, foldnorm,
# foldcauchy, exponnorm, invgauss, wald, recipinvgauss, genexpon,
# kstwobign, rel_breitwigner), pearson3, gennorm and halfgennorm (their
# gammaincinv argument escapes the trip caps) and erlang.  The port
# follows it: those run on the plain path.
_CLOSED_FORM_FAMILIES = (
    "uniform", "norm", "expon", "lognorm", "triang", "truncnorm", "cauchy", "laplace",
    "logistic", "gumbel_r", "gumbel_l", "rayleigh", "halfnorm", "pareto", "weibull_min",
    "weibull_max", "powerlaw", "loguniform", "arcsine", "hypsecant", "fisk", "genpareto",
    "genextreme", "bernoulli", "geom", "randint", "alpha", "bradford", "burr", "burr12",
    "dweibull", "exponpow", "exponweib", "fatiguelife", "genhalflogistic", "genlogistic",
    "gibrat", "gompertz", "halfcauchy", "halflogistic", "invweibull", "johnsonsb",
    "johnsonsu", "kappa3", "laplace_asymmetric", "levy", "levy_l", "loglaplace", "lomax",
    "mielke", "moyal", "powerlognorm", "powernorm", "trapezoid", "truncexpon",
    "truncpareto", "truncweibull_min", "tukeylambda", "reciprocal", "skewcauchy", "kappa4",
    "crystalball",
)

# Families solved by Newton on the incomplete gamma and beta functions
# (pallas_exec._INCOMPLETE_FAMILY_CAPS): the series and continued-fraction
# trip counts are sized for shape parameters in (0, cap], so a node whose
# shape parameter is a Node, a bool or outside that range is refused.
# None: the shape is fixed (maxwell's a = 1.5).
INCOMPLETE_FAMILY_CAPS = {
    "gamma": 30.0, "invgamma": 30.0, "chi2": 60.0, "chi": 60.0, "maxwell": None,
    "nakagami": 30.0, "beta": 30.0, "betaprime": 30.0, "t": 60.0, "f": 60.0,
    "dgamma": 30.0, "loggamma": 30.0, "gengamma": 30.0, "rdist": 60.0, "argus": 60.0,
}

_FAMILY_OPS = {
    family: f"PPF_{family.upper()}"
    for family in (*_CLOSED_FORM_FAMILIES, *INCOMPLETE_FAMILY_CAPS)
}
NEWTON_OPS = {_FAMILY_OPS[family]: family for family in INCOMPLETE_FAMILY_CAPS}
# The kind of inverse each Newton family solves: "gamma" (P(a, x) = p) or
# "beta" (I_x(a, b) = p).
NEWTON_KIND = {
    family: "beta" if family in ("beta", "betaprime", "t", "f", "rdist") else "gamma"
    for family in INCOMPLETE_FAMILY_CAPS
}

_TRANSFORM_OPS = {
    _graph.Add: "ADD",
    _graph.Multiply: "MUL",
    _graph.Max: "MAX",
    _graph.Min: "MIN",
    _graph.All: "AND",
    _graph.Any: "OR",
    _graph.FloorDivide: "FLOORDIV",
    _graph.Mod: "MOD",
    _graph.Divide: "DIV",
    _graph.Power: "POW",
    _graph.Subtract: "SUB",
    _graph.Equal: "EQ",
    _graph.NotEqual: "NE",
    _graph.LessThan: "LT",
    _graph.LessThanOrEqual: "LE",
    _graph.GreaterThan: "GT",
    _graph.GreaterThanOrEqual: "GE",
    _graph.IsClose: "ISCLOSE",
    _graph.Arctan2: "ATAN2",
    _graph.Negate: "NEG",
    _graph.Abs: "ABS",
    _graph.Log: "LOG",
    _graph.Exp: "EXP",
    _graph.Floor: "FLOOR",
    _graph.Ceil: "CEIL",
    _graph.Sign: "SIGN",
    _graph.Sqrt: "SQRT",
    _graph.Square: "SQUARE",
    _graph.Log10: "LOG10",
    _graph.Sin: "SIN",
    _graph.Cos: "COS",
    _graph.Tan: "TAN",
    _graph.Arcsin: "ASIN",
    _graph.Arccos: "ACOS",
    _graph.Arctan: "ATAN",
    _graph.Sinh: "SINH",
    _graph.Cosh: "COSH",
    _graph.Tanh: "TANH",
    _graph.Arcsinh: "ASINH",
    _graph.Arccosh: "ACOSH",
    _graph.Arctanh: "ATANH",
    _graph.Log1p: "LOG1P",
    _graph.Expm1: "EXPM1",
}

_TABLE_OPS = ("TABLE_CDF", "TABLE_DISCRETE", "TABLE_INTERP")

# Opcode numbering; ``_EMIT`` below gives each name its CUDA text.
OPCODES = (
    ["DRAW", "LOADK", "STORE", "SCORE", "RECOLOR", "NDTR", "AFFINE", *_TABLE_OPS]
    + list(_FAMILY_OPS.values())
    + list(_SCORE_OPS.values())
    + list(_TRANSFORM_OPS.values())
    + ["TO_FLOAT"]
)
_OPCODE = {name: i for i, name in enumerate(OPCODES)}

# Value kinds (see the module docstring): the dtype of each kind on the
# twin, the C type of each in the generated text, and the lattice order.
KINDS = "bif"
_DTYPE = {"b": torch.bool, "i": torch.int32, "f": torch.float32}
_CTYPE = {"b": "bool", "i": "int", "f": "float"}
_TRANSFORM_FN = {op: cls.op for cls, op in _TRANSFORM_OPS.items()}
_COMPARISONS = ("EQ", "NE", "LT", "LE", "GT", "GE")


def const_kind(value):
    """The kind of a constant's Python value, as ``Constant._emit`` types
    it in both packages: a bool, an int (int32), anything else float32.
    An int outside the int32 range raises what the plain executor raises
    (``torch.full`` refuses to narrow it)."""
    if isinstance(value, bool):
        return "b"
    if isinstance(value, numbers.Integral):
        torch.full((1,), value, dtype=_DTYPE["i"])
        return "i"
    return "f"


@functools.lru_cache(maxsize=None)
def _transform_kind(name, operand_kinds):
    args = [None if k is None else torch.ones(1, dtype=_DTYPE[k]) for k in operand_kinds]
    dtype = _TRANSFORM_FN[name](*args).dtype
    return "b" if dtype == torch.bool else "f" if dtype.is_floating_point else "i"


def value_kind(name, operand_kinds):
    """The kind of the value a row ``name`` computes from operands of
    ``operand_kinds`` (None: a ``NoOp``'s missing value).

    A transform's kind is the dtype the port's plain executor gives it
    (its own ``op`` on one-element tensors of those kinds, which follows
    ``jnp`` on the CPU), and what that executor refuses (a bool negated,
    bool - bool, a ``NoOp`` read) raises the same exception here.  Every
    other row (draws, ppfs, tables, the recolour rows, ``TO_FLOAT``)
    computes float32.  Lowering, generation, the twin and ``supports``
    all type the tape through this function.
    """
    if name in _TRANSFORM_FN:
        return _transform_kind(name, tuple(operand_kinds))
    if None in operand_kinds:
        raise TypeError(f"A {name} row reads a NoOp, which has no value.")
    return "f"


def _compute_kind(name, operand_kinds, kind):
    """The kind a row computes in: a comparison in the larger of its
    operands' kinds (``ISCLOSE`` in float32, as ``jnp.isclose`` promotes
    to inexact), every other row in the kind of its value (``AND`` and
    ``OR`` read their operands as bools)."""
    if name == "ISCLOSE":
        return "f"
    if name in _COMPARISONS:
        return max(operand_kinds, key=KINDS.index)
    return kind


def program_kinds(program, consts):
    """The kind of every row of a value-numbered ``program`` (None for a
    ``STORE`` or a ``SCORE``, which define no value), its ``LOADK`` rows
    typed by ``consts`` in row order."""
    consts = iter(consts)
    kind_of, kinds = {}, []
    for row in program:
        op, dst = row[0], row[1]
        name = OPCODES[op]
        if name == "LOADK":
            kind = const_kind(next(consts))
        else:
            operands = [kind_of[row[f]] for f in _register_fields(op)[1] if row[f] >= 0]
            kind = value_kind(name, operands)
        if name in ("STORE", "SCORE"):
            kinds.append(None)
        else:
            kind_of[dst] = kind
            kinds.append(kind)
    return tuple(kinds)


def _ppf_params(node):
    """The node's ppf parameters after ``q``, in signature order, defaults
    filled in (numbers or Nodes)."""
    sig = inspect.signature(_ppf.lookup(node.distr))
    bound = sig.bind(None, *node.args, **node.kwargs)
    bound.apply_defaults()
    return list(bound.arguments.values())[1:]


def _n_shapes(family):
    """The number of shape parameters of a family: its ppf's parameters
    between ``q`` and ``loc`` (and ``scale``)."""
    names = list(inspect.signature(_ppf.lookup(family)).parameters)
    return len(names) - (3 if "scale" in names else 2)


def _incomplete_family_ok(node):
    """``pallas_exec._incomplete_family_ok``: every shape parameter the node
    was given (its arguments but loc and scale) is a real number, no bool,
    in (0, cap]."""
    cap = INCOMPLETE_FAMILY_CAPS[node.distr]
    shapes = list(node.args) + [v for k, v in node.kwargs.items() if k not in ("loc", "scale")]
    for v in shapes:
        if not isinstance(v, numbers.Real) or isinstance(v, bool):
            return False
        if not 0 < float(v) <= (cap if cap is not None else float("inf")):
            return False
    return True


_TRIMMED_TABLE_CACHE = {}


def trimmed_cdf_table(node):
    """(float32 CDF table, loc) of a static discrete ``Distribution``,
    trimmed to the kernel's reachable quantiles, or None.

    ``pallas_exec._trimmed_cdf_table``: the float64 table
    (``ppf.static_cdf_table``) is cast to float32 by numpy, as
    ``ppf._table_ppf`` casts it, then trimmed at both ends to what the
    kernel's uniforms, q in [2^-24, 1 - 2^-24], can reach: the tail after
    the first entry >= 1 - 2^-24 (the strict search never passes it), and
    the leading entries below 2^-24 (every q exceeds them), whose count is
    folded into ``loc``.  Cached by the node's signature and the float
    dtype (the generic table's eps depends on it).
    """
    key = (node._static_signature(), str(config.float_dtype()))
    if key in _TRIMMED_TABLE_CACHE:
        return _TRIMMED_TABLE_CACHE[key]
    built = _ppf.static_cdf_table(node.distr, *node.args, **node.kwargs)
    if built is None:
        result = None
    else:
        table, loc = built
        t32 = np.asarray(table, np.float32)
        reachable = np.nonzero(t32 >= np.float32(1.0 - 2.0**-24))[0]
        if len(reachable):
            t32 = t32[: reachable[0] + 1]
        lead = int(np.searchsorted(t32, np.float32(2.0**-24), side="left"))
        lead = min(lead, len(t32) - 1)  # keep at least one entry
        result = (t32[lead:], loc + lead)
    if len(_TRIMMED_TABLE_CACHE) > 256:
        _TRIMMED_TABLE_CACHE.pop(next(iter(_TRIMMED_TABLE_CACHE)))
    _TRIMMED_TABLE_CACHE[key] = result
    return result


def _table_node_ok(node):
    """``pallas_exec._table_node_ok``: a static discrete family whose
    trimmed table, a numeric Discrete, a Cumulative, or a linear numeric
    Empirical whose data, has at most ``TABLE_MAX`` entries."""
    if isinstance(node, Distribution):
        built = trimmed_cdf_table(node)
        return built is not None and len(built[0]) <= TABLE_MAX
    if isinstance(node, DiscreteDistribution):
        return np.issubdtype(node.values.dtype, np.number) and len(node.values) <= TABLE_MAX
    if isinstance(node, CumulativeDistribution):
        return len(node.q) <= TABLE_MAX
    if isinstance(node, EmpiricalDistribution):
        return (
            np.issubdtype(node.data.dtype, np.number)
            and node.kwargs.get("method", "linear") == "linear"
            and all(k == "method" for k in node.kwargs)
            and len(node.data) <= TABLE_MAX
        )
    return False


def _structure_ok(plan, keep_ids):
    """Can every node and the keep-set be expressed on the tape?"""
    if len(plan.corr_vars) > MAX_CORR_K:
        return False
    topo_ids = {node._id for node in plan.topo}
    if plan.sink._id not in keep_ids or not keep_ids <= topo_ids:
        return False
    if len(keep_ids) > MAX_KEEP:
        return False
    for node in plan.topo:
        if isinstance(node, _graph.Constant):
            if not isinstance(node.value, numbers.Real):
                return False
        elif isinstance(node, _graph.ScalarFunctionTransform):
            return False  # a Python function: no kernel op, as on the TPU
        elif isinstance(node, Distribution) and node.distr in _FAMILY_OPS:
            if node.distr in INCOMPLETE_FAMILY_CAPS and not _incomplete_family_ok(node):
                return False  # and no table: the family has its own ppf
            try:
                _ppf_params(node)
            except TypeError:
                return False
        elif node._is_distribution:
            if not _table_node_ok(node):
                return False
        elif type(node) not in _TRANSFORM_OPS and not isinstance(node, (_graph.Avg, _graph.NoOp)):
            return False  # node types without a kernel op
    return not isinstance(plan.sink, _graph.NoOp)


def supports(plan, keep_ids):
    """True if this graph can run as the CUDA megakernel.

    The counterpart of ``pallas_exec.supports``: graphs of Constants, the
    TPU kernel's closed-form families (``_CLOSED_FORM_FAMILIES``), Newton
    families within their caps (``INCOMPLETE_FAMILY_CAPS``), table nodes
    of at most ``TABLE_MAX`` entries (``_table_node_ok``), and the
    arithmetic transforms on float32, int32 and bool values, with at most
    16 correlated variables and at most 16 kept nodes including the sink,
    no ``NoOp`` sink and no ``ScalarFunctionTransform``; and a tape within the caps that remain: at most
    ``MAX_INSTR`` rows (the generated text and its build time grow with
    them), ``MAX_CONSTS`` constants (they travel in the kernel's
    parameters), tables and recolour arrays within one block's
    ``MAX_SHARED_BYTES`` and, for the plain twin alone, ``MAX_SLOTS``
    values live at once.

    A graph that the plain executor cannot evaluate (a bool negated, a
    ``NoOp`` read by a transform, an int constant beyond int32) is
    supported, as ``pallas_exec.supports`` admits it: lowering it raises
    the plain executor's exception, as the TPU kernel fails to trace.
    """
    keep_ids = frozenset(keep_ids)
    if not _structure_ok(plan, keep_ids):
        return False
    try:
        lowered(plan, keep_order(plan, keep_ids))  # the tape's size caps
    except ValueError:
        return False
    except (TypeError, AttributeError, RuntimeError):
        return True  # the graph fails on every executor (see above)
    return True


def environment_issue(device=None):
    """None if the kernel can run on ``device`` (default
    ``config.device()``), else the reason it cannot."""
    from probabilit_tpu_torch.parallel import mesh as _mesh

    if _mesh.current_mesh() is not None:
        return (
            "executor='cuda' does not run under a device mesh; use the default "
            "executor for sharded sampling."
        )
    device = config.device() if device is None else torch.device(device)
    if not torch.cuda.is_available():
        return (
            "executor='cuda' requires a CUDA device, and "
            "torch.cuda.is_available() is False."
        )
    if device.type != "cuda":
        return (
            f"executor='cuda' runs on config.device(), which is {str(device)!r}; "
            "call config.set_device('cuda') first."
        )
    capability = torch.cuda.get_device_capability(device)
    if capability != (9, 0):
        return (
            "executor='cuda' is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has capability {capability}."
        )
    if config.float_dtype() != torch.float32:
        return "executor='cuda' is float32-only."
    return None


def keep_order(plan, keep_ids):
    """Output row order: other kept nodes in topo order, the sink last."""
    order = [
        node._id
        for node in plan.topo
        if node._id in keep_ids and node._id != plan.sink._id
    ]
    order.append(plan.sink._id)
    return order


@dataclass(frozen=True)
class Tape:
    """A lowered plan: the kernel's program and its shape."""

    code: torch.Tensor  # int32 (n_instr, 6): [opcode, dst, a, b, c, d] on slots
    imm: torch.Tensor  # float64 (n_instr,): the LOADK rows' values, exact
    n_slots: int
    d: int  # uniform columns drawn
    keep_order: tuple  # node ids of the output rows
    n_corr: int = 0  # correlated variables: (A, b) holds n_corr^2 + n_corr floats
    program: tuple = ()  # the rows of ``code`` on value numbers: what ``generate`` reads
    consts: tuple = ()  # the LOADK rows' immediates in row order: float (float32), int or bool
    # float32: every table row's data, each table padded to a multiple of 4,
    # then the guides (their 32-bit words)
    tables: torch.Tensor = field(default_factory=lambda: torch.zeros(0))
    # per table row with a guide: (its value number, the guide's offset in
    # ``tables``, its cells, its search window)
    guides: tuple = ()

    @property
    def n_instr(self):
        return self.code.shape[0]

    @property
    def n_keep(self):
        return len(self.keep_order)

    @property
    def shared_bytes(self):
        """Shared memory a block of the kernel takes: the tables and the
        Newton tier's quantiles (dynamic), the recolour arrays and the
        Newton rows' constants (static)."""
        return 4 * (self.tables.numel() + self.slot_floats) + _recolor_bytes(self.n_corr) + (
            _newton_static_bytes(len(self.newton_rows)))

    @functools.cached_property
    def newton_rows(self):
        """The indices of ``program``'s Newton rows (``NEWTON_OPS``)."""
        return tuple(i for i, row in enumerate(self.program) if OPCODES[row[0]] in NEWTON_OPS)

    @property
    def newton_groups(self):
        """Groups a thread covers in each turn of the Newton tier's loop:
        ``NEWTON_SLOTS // R`` for R Newton rows, or fewer where the tables
        and the recolour arrays leave less shared memory (at least one; 0
        without Newton rows)."""
        rows = len(self.newton_rows)
        if not rows:
            return 0
        free = (MAX_SHARED_BYTES - 4 * (self.tables.numel() - self.guide_floats)
                - _recolor_bytes(self.n_corr) - _newton_static_bytes(rows))
        return max(1, min(NEWTON_SLOTS // rows, free // (4 * _TILE * rows)))

    @property
    def guide_floats(self):
        """The floats of ``tables`` that hold the guides (after the tables)."""
        return sum(cells for _, _, cells, _ in self.guides)

    @property
    def slot_floats(self):
        """Floats of dynamic shared memory that hold the Newton tier's
        quantiles: one per sample of a turn and Newton row."""
        return self.newton_groups * len(self.newton_rows) * _TILE

    def to(self, device):
        return Tape(
            self.code.to(device), self.imm.to(device), self.n_slots, self.d,
            self.keep_order, self.n_corr, self.program, self.consts, self.tables.to(device),
            self.guides,
        )

    @functools.cached_property
    def source(self):
        """The CUDA C++ text of this tape's kernel (``generate``)."""
        return generate(self)

    @functools.cached_property
    def kernel(self):
        """The launch function of this tape's kernel, built at first use."""
        return _megakernel(self.source)

    @functools.cached_property
    def kinds(self):
        """The kind of every row of ``program`` (``program_kinds``)."""
        return program_kinds(self.program, self.consts)

    @functools.cached_property
    def const_block(self):
        """``consts`` as the C array of 32-bit words the launch function
        copies into the kernel's parameter block: a float's bits, an int's
        or a bool's two's complement, never rounded through a float."""
        words = [
            int(np.float32(v).view(np.uint32)) if const_kind(v) == "f"
            else int(np.int32(v).view(np.uint32))
            for v in self.consts
        ]
        return (ctypes.c_uint32 * max(len(words), 1))(*words)


def _pad4(n):
    return -(-n // 4) * 4


def _newton_static_bytes(rows):
    """Static shared memory of the Newton tier: each row's family, shapes
    and constants (``newton_ops::Row``, 20 bytes) and the block's work
    counter."""
    return 20 * rows + 4 if rows else 0


def _recolor_bytes(k):
    """Static shared memory of the recolour arrays: A, rows padded to four
    floats, and b."""
    return 4 * (k * _pad4(k) + k)


def _padded(values, n):
    """``values`` as float32, zero-padded to ``n`` floats."""
    out = np.zeros(n, np.float32)
    out[: len(values)] = values
    return out


def cdf_layout(table):
    """(boundaries, float32 data) of a ``TABLE_CDF`` row on the trimmed
    float32 CDF ``table``: the table but its last entry.  The row counts
    the boundaries below q (``searchsorted`` side ``left``)."""
    nb = len(table) - 1
    return nb, _padded(table[:-1], _pad4(nb))


def discrete_layout(cumulative, values):
    """(boundaries, float32 data) of a ``TABLE_DISCRETE`` row: the
    boundaries ``float32(cumulative)[:n - 1]``, then the ``n`` values in
    float32.  The row takes the value at the count of boundaries at or
    below q (side ``right``)."""
    nb = len(values) - 1
    return nb, np.concatenate(
        [_padded(np.asarray(cumulative)[:nb], _pad4(nb)), _padded(values, _pad4(nb + 1))]
    )


def interp_layout(xp, fp):
    """(boundaries, float32 data) of a ``TABLE_INTERP`` row for knots
    ``xp`` (non-decreasing) and values ``fp``: the boundaries ``xp[:-1]``
    (side ``right``), one float4 ``(x0, f0, slope, 0)`` per interval
    (interval 0, below ``xp[0]``: ``(0, fp[0], 0)``; a zero-width interval
    ``(x0, fp[i], 0)``; the slope computed in float64 and rounded once, as
    ``pallas_exec._kernel_interp`` does), then ``(xp[-1], fp[-1], 0, 0)``,
    the clamp at the right end."""
    xp, fp = np.asarray(xp, np.float64), np.asarray(fp, np.float64)
    nb = len(xp) - 1
    leaves = np.zeros((nb + 1, 4), np.float32)
    leaves[0, 1] = fp[0]
    for i in range(1, nb + 1):
        x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
        if x1 > x0:
            leaves[i, :3] = x0, f0, (f1 - f0) / (x1 - x0)
        else:
            leaves[i, :2] = x0, f1
    tail = np.array([xp[-1], fp[-1], 0.0, 0.0], np.float32)
    return nb, np.concatenate([_padded(xp[:-1], _pad4(nb)), leaves.ravel(), tail])


def table_data(node):
    """(opcode, boundaries, float32 data, loc) of a table node's row, in
    the layouts ``csrc/table_ops.cuh`` reads (every section padded to a
    multiple of four floats): a static discrete family's trimmed CDF table
    (``cdf_layout``; ``loc`` is added by an ``ADD`` row after it), a
    numeric Discrete (``discrete_layout``), a Cumulative
    ``(q, cumulatives)`` and a linear Empirical
    ``(linspace(0, 1, m), sort(data))`` (``interp_layout``)."""
    if isinstance(node, Distribution):
        table, loc = trimmed_cdf_table(node)
        return ("TABLE_CDF", *cdf_layout(table), loc)
    if isinstance(node, DiscreteDistribution):
        return ("TABLE_DISCRETE", *discrete_layout(np.cumsum(node.probabilities), node.values),
                None)
    if isinstance(node, CumulativeDistribution):
        return ("TABLE_INTERP", *interp_layout(node.q, node.cumulatives), None)
    data = np.sort(node.data)
    return ("TABLE_INTERP", *interp_layout(np.linspace(0.0, 1.0, len(data)), data), None)


def table_guide(bounds, cells, window):
    """The guide of a table row's sorted float32 ``bounds`` with ``cells``
    cells (a power of two) for a search ``window`` of 1, 2, 4 or 8
    boundaries, as the float32 bit patterns of its 32-bit words.  Cell j
    covers q in [j / cells, (j + 1) / cells) (the first from -inf, the last
    to +inf) and holds the boundaries from lo_j, the count below j / cells
    (0 for cell 0), to lo_{j+1} (the last: all of them); j / cells is exact
    in float32, so every count is exact.  A cell of at most ``window``
    boundaries has the first boundary of a window of ``window`` that holds
    them, ``min(lo_j, nb - window)``; a crowded one has its top bit set and
    lo_j below it (the kernel searches the whole table).
    ``csrc/table_ops.cuh`` reads the word of cell ``floor(q cells)``."""
    bounds = np.asarray(bounds, np.float32)
    edges = (np.arange(1, cells) / cells).astype(np.float32)
    lo = np.concatenate([[0], np.searchsorted(bounds, edges, side="left"), [len(bounds)]])
    occupancy, lo = np.diff(lo), lo[:-1]
    words = np.where(occupancy <= window, np.minimum(lo, len(bounds) - window), (1 << 31) | lo)
    return words.astype(np.uint32).view(np.float32)


def guide_cells(nbs, free_bytes, window=None):
    """The cells of each table row's guide, for tables of ``nbs``
    boundaries in ``free_bytes`` of shared memory: the smallest power of
    two at least ``GUIDE_SPREAD * (nb + 1)``, within 4 .. ``GUIDE_MAX_CELLS``;
    while the guides exceed ``free_bytes``, the first of the largest halves,
    and a guide of 4 cells goes (1 cell: no guide, the full search).  A
    table of fewer than ``GUIDE_MIN_BOUNDARIES`` boundaries, or no more
    than the ``window`` (default ``GUIDE_WINDOW``), has none.  A function of
    the structure alone, never of the boundaries' values."""
    window = GUIDE_WINDOW if window is None else window
    cells = [1 if nb <= window or nb < GUIDE_MIN_BOUNDARIES
             else min(GUIDE_MAX_CELLS, max(4, 1 << (GUIDE_SPREAD * (nb + 1) - 1).bit_length()))
             for nb in nbs]
    while 4 * sum(c for c in cells if c > 1) > free_bytes:
        i = cells.index(max(cells))
        cells[i] = cells[i] // 2 if cells[i] > 4 else 1
    return cells


def _with_guides(tape, table_rows):
    """``tape`` with a guide after its tables for each of ``table_rows``
    (value number, boundaries, them in float32) that ``guide_cells``
    gives room: what is left of ``MAX_SHARED_BYTES`` and, where four blocks
    of ``tape`` share an SM, of a quarter of ``SM_SHARED_BYTES``."""
    base = tape.shared_bytes
    four = SM_SHARED_BYTES // 4 - 1024
    limit = four if base <= four else MAX_SHARED_BYTES
    cells = guide_cells([nb for _, nb, _ in table_rows], limit - base)
    offset = tape.tables.numel()
    guides, words = [], []
    for (dst, _, bounds), m in zip(table_rows, cells):
        if m > 1:
            guides.append((dst, offset, m, GUIDE_WINDOW))
            words.append(table_guide(bounds, m, GUIDE_WINDOW))
            offset += m
    if not guides:
        return tape
    tables = torch.cat([tape.tables, torch.from_numpy(np.concatenate(words))])
    return replace(tape, tables=tables, guides=tuple(guides))


def lower(plan, keep_order):
    """Turn ``plan`` into a ``Tape`` whose ``STORE k`` rows write the nodes
    of ``keep_order``; raises ``ValueError`` on a graph ``supports`` refuses.

    Values are first numbered one per instruction, then mapped onto slots:
    a slot is free again after the last instruction that reads it.  A
    correlated plan's tape opens with ``DRAW`` and ``SCORE`` for each
    correlated variable (the scores live in their own registers, so no
    slot allocation can reuse them), and each correlated variable is
    ``RECOLOR i`` followed by its score ppf, or ``NDTR`` and its ppf.
    """
    if not _structure_ok(plan, frozenset(keep_order)):
        raise ValueError("This graph is not supported by the CUDA megakernel.")
    rows = []  # [op, dst, a, b, c, d, imm]; dst and a..d are value numbers
    new_value = itertools.count()
    value_of = {}  # node id -> value number (None for a NoOp)
    kind_of = {None: None}  # value number -> kind

    def emit(op, srcs=(), imm=0.0):
        if op == "LOADK":
            kind = const_kind(imm)
            imm = {"b": bool, "i": int, "f": lambda x: float(np.float32(x))}[kind](imm)
        else:
            kind = value_kind(op, [kind_of[s] for s in srcs])
        v = next(new_value)
        kind_of[v] = kind
        srcs = list(srcs) + [-1] * (4 - len(srcs))
        rows.append([_OPCODE[op], v, *srcs, imm])
        return v

    def operand(x):
        """A ppf parameter: a node's value, or a number as a float32 constant."""
        return value_of[x._id] if isinstance(x, _graph.Node) else emit("LOADK", imm=float(x))

    def emit_ppf(node, q):
        params = [operand(p) for p in _ppf_params(node)]
        k = _n_shapes(node.distr)
        x = emit(_FAMILY_OPS[node.distr], [q, *params[:k]])
        if len(params) == k + 1:  # a discrete family: loc, no scale
            return emit("ADD", [x, params[k]])
        return emit("AFFINE", [x, params[k], params[k + 1]])

    tables = []  # float32 sections, each a multiple of 4 floats
    table_rows = []  # per table row: (value number, boundaries, them in float32)

    def emit_sampler(node, q):
        """The node's inverse CDF at the value ``q``."""
        if isinstance(node, Distribution) and node.distr in _FAMILY_OPS:
            return emit_ppf(node, q)
        op, nb, data, loc = table_data(node)
        v = emit(op, [q])
        rows[-1][3:5] = [sum(map(len, tables)), nb]  # b, c: offset and boundaries (literals)
        tables.append(data)
        table_rows.append((v, nb, data[:nb]))
        return v if loc is None else emit("ADD", [v, emit("LOADK", imm=float(loc))])

    corr_index = {v._id: i for i, v in enumerate(plan.corr_vars)}
    for i, var in enumerate(plan.corr_vars):
        u = emit("DRAW")
        rows[-1][2] = plan.col_of[var._id]
        rows.append([_OPCODE["SCORE"], i, u, -1, -1, -1, 0.0])  # dst: score index

    for node in plan.topo:
        if isinstance(node, _graph.Constant):
            v = emit("LOADK", imm=node.value)
        elif node._id in corr_index:
            y = emit("RECOLOR")
            rows[-1][2] = corr_index[node._id]  # a: the variable's index (a literal)
            if isinstance(node, Distribution) and node.distr in _SCORE_OPS:
                v = emit(_SCORE_OPS[node.distr], [y, *(operand(p) for p in _ppf_params(node))])
            else:
                v = emit_sampler(node, emit("NDTR", [y]))
        elif node._is_distribution:
            q = emit("DRAW")
            rows[-1][2] = plan.col_of[node._id]  # a: the column (a literal)
            v = emit_sampler(node, q)
        elif isinstance(node, _graph.NoOp):
            v = None
        elif isinstance(node, _graph.Avg):
            # Avg converts every operand to float before it adds.
            vals = [value_of[p._id] for p in node.parents]
            vals = [x if kind_of[x] == "f" else emit("TO_FLOAT", [x]) for x in vals]
            acc = vals[0]
            for x in vals[1:]:
                acc = emit("ADD", [acc, x])
            v = emit("DIV", [acc, emit("LOADK", imm=float(len(vals)))])
        elif isinstance(node, _graph.VariadicTransform):
            vals = [value_of[p._id] for p in node.parents]
            v = vals[0]
            for x in vals[1:]:
                v = emit(_TRANSFORM_OPS[type(node)], [v, x])
        else:
            v = emit(
                _TRANSFORM_OPS[type(node)],
                [value_of[p._id] for p in node.get_parents()],
            )
        value_of[node._id] = v
    for k, nid in enumerate(keep_order):
        value_kind("STORE", [kind_of[value_of[nid]]])  # a kept NoOp has nothing to store
        rows.append([_OPCODE["STORE"], k, value_of[nid], -1, -1, -1, 0.0])

    # An int or bool constant that every row reads as a float is carried
    # as its float32 value (the same rounding the kernel's conversion
    # makes): nothing converts it in the kernel, and a float graph's text
    # stays what it was before the tape was typed.
    as_float = {}
    for row in rows:
        srcs = [row[f] for f in _register_fields(row[0])[1] if row[f] >= 0]
        name = OPCODES[row[0]]
        compute = "f"  # ppfs, tables, recolour rows, TO_FLOAT, STORE
        if name in _TRANSFORM_FN:
            compute = _compute_kind(name, [kind_of[v] for v in srcs], kind_of[row[1]])
        for v in srcs:
            as_float[v] = as_float.get(v, True) and compute == "f"
    for row in rows:
        if row[0] == _OPCODE["LOADK"] and kind_of[row[1]] != "f" and as_float.get(row[1]):
            row[6] = float(np.float32(row[6]))

    code, n_slots = _allocate_slots(rows)
    imm = np.array([float(r[6]) for r in rows], dtype=np.float64)
    consts = tuple(r[6] for r in rows if r[0] == _OPCODE["LOADK"])
    tape = Tape(
        torch.from_numpy(code), torch.from_numpy(imm), n_slots, plan.d,
        tuple(keep_order), len(plan.corr_vars), tuple(tuple(r[:6]) for r in rows), consts,
        torch.from_numpy(np.concatenate(tables) if tables else np.zeros(0, np.float32)),
    )
    if (
        tape.n_instr > MAX_INSTR or tape.n_slots > MAX_SLOTS or len(consts) > MAX_CONSTS
        or tape.shared_bytes > MAX_SHARED_BYTES
    ):
        raise ValueError(
            f"The tape needs {tape.n_instr} instructions, {len(consts)} constants, "
            f"{tape.n_slots} slots and {tape.shared_bytes} bytes of shared memory; "
            f"the caps are {MAX_INSTR}, {MAX_CONSTS}, {MAX_SLOTS} and {MAX_SHARED_BYTES}."
        )
    return _with_guides(tape, table_rows)


def lowered(plan, keep_order, device="cpu"):
    """``lower(plan, keep_order).to(device)``, cached on the plan per keep
    order and device, so one ``sample`` or ``estimate`` call lowers once and
    every later call on the same graph reuses the tape and its loaded
    kernel.  (A plan is itself cached per sink until the graph changes.)"""
    cache = plan.__dict__.setdefault("_cuda_tapes", {})
    device = torch.device(device)
    key = (tuple(keep_order), device)
    tape = cache.get(key)
    if tape is None:
        cpu_key = (key[0], torch.device("cpu"))
        if cpu_key not in cache:
            cache[cpu_key] = lower(plan, keep_order)
        tape = cache[key] = cache[cpu_key] if key == cpu_key else cache[cpu_key].to(device)
    return tape


def _register_fields(op):
    """(dst is a value, operand fields that are values) for an opcode."""
    name = OPCODES[op]
    if name in ("DRAW", "RECOLOR", "LOADK"):
        return True, ()  # a, if any, is a column number / a variable's index
    if name in ("STORE", "SCORE"):
        return False, (2,)  # dst is the output row / the score's index
    if name in _TABLE_OPS:
        return True, (2,)  # b and c are the table's offset and boundaries
    return True, (2, 3, 4, 5)


def _allocate_slots(rows):
    """Map value numbers to slots by liveness; returns (int32 code, n_slots)."""
    last_read = {}
    for i, row in enumerate(rows):
        _, fields = _register_fields(row[0])
        for f in fields:
            if row[f] >= 0:
                last_read[row[f]] = i
    slot_of, free, n_slots = {}, [], 0
    code = np.full((len(rows), 6), -1, dtype=np.int32)
    for i, row in enumerate(rows):
        has_dst, fields = _register_fields(row[0])
        code[i, 0] = row[0]
        code[i, 1:6] = row[1:6]
        for f in fields:
            if row[f] >= 0:
                code[i, f] = slot_of[row[f]]
        # Sources read for the last time free their slots before dst is
        # placed: the kernel reads every operand before it writes.
        for f in fields:
            v = row[f]
            if v >= 0 and last_read[v] == i and v in slot_of:
                free.append(slot_of.pop(v))
        if has_dst:
            if free:
                slot = free.pop()
            else:
                slot, n_slots = n_slots, n_slots + 1
            code[i, 1] = slot
            if row[1] in last_read:
                slot_of[row[1]] = slot
            else:
                free.append(slot)  # Never read.
    return code, n_slots


# The CUDA text of one value, per opcode: {a}..{d} are its operands (a lane's
# named values, or a constant read from the parameter block).  The
# functions are csrc/graph_ops.cuh's and csrc/ppf_ops.cuh's and CUDA's
# float32 libm.  DRAW, LOADK, STORE, SCORE and RECOLOR have their own
# shapes (see ``generate``).  A family's row calls ``ppf_<family>`` on q
# and its shapes, a Newton family's reads the block's solve (``{slot}``:
# its offset in ``s_newton``); a table row (csrc/table_ops.cuh) its full
# search on q, with {b} the table's offset in shared memory and {c} its
# boundaries (``_GUIDED_EMIT``: with a guide).
_EMIT = {
    "DRAW": "bits_to_open_unit({word})",
    "LOADK": "k.v[{index}]",
    "STORE": "store_group(out + {row} * n, r0, n, vec, {lanes}, bad);",
    "SCORE": "ndtri_fast({a})",
    "RECOLOR": "{b} + {terms}",
    "NDTR": "ndtr_open({a})",
    "AFFINE": "{b} + {c} * {a}",
    "TABLE_CDF": "table_cdf<{c}>(s_tab + {b}, {a})",
    "TABLE_DISCRETE": "table_discrete<{c}>(s_tab + {b}, {a})",
    "TABLE_INTERP": "table_interp<{c}>(s_tab + {b}, {a})",
    **{
        op: f"ppf_{family}(" + ", ".join("{%s}" % f for f in "abcd"[: 1 + _n_shapes(family)]) + ")"
        for family, op in _FAMILY_OPS.items() if op not in NEWTON_OPS
    },
    # A Newton row reads its value where the block's solve left it.
    **{op: "s_newton[{slot} + threadIdx.x]" for op in NEWTON_OPS},
    "SCORE_NORM": "score_norm({a}, {b}, {c})",
    "SCORE_LOGNORM": "score_lognorm({a}, {b}, {c}, {d})",
    "ADD": "{a} + {b}",
    "MUL": "{a} * {b}",
    "MAX": "nan_max({a}, {b})",
    "MIN": "nan_min({a}, {b})",
    "AND": "{a} && {b}",
    "OR": "{a} || {b}",
    "FLOORDIV": "floor_divide({a}, {b})",
    "MOD": "floor_mod({a}, {b})",
    "DIV": "{a} / {b}",
    "POW": "powf({a}, {b})",
    "SUB": "{a} - {b}",
    "EQ": "{a} == {b}",
    "NE": "{a} != {b}",
    "LT": "{a} < {b}",
    "LE": "{a} <= {b}",
    "GT": "{a} > {b}",
    "GE": "{a} >= {b}",
    "ISCLOSE": "isclose({a}, {b})",
    "ATAN2": "atan2f({a}, {b})",
    "NEG": "-{a}",
    "ABS": "fabsf({a})",
    "LOG": "logf({a})",
    "EXP": "expf({a})",
    "FLOOR": "floorf({a})",
    "CEIL": "ceilf({a})",
    "SIGN": "sign({a})",
    "SQRT": "sqrtf({a})",
    "SQUARE": "{a} * {a}",
    "LOG10": "log10f({a})",
    "SIN": "sinf({a})",
    "COS": "cosf({a})",
    "TAN": "tanf({a})",
    "ASIN": "asinf({a})",
    "ACOS": "acosf({a})",
    "ATAN": "atanf({a})",
    "SINH": "sinhf({a})",
    "COSH": "coshf({a})",
    "TANH": "tanhf({a})",
    "ASINH": "asinhf({a})",
    "ACOSH": "acoshf({a})",
    "ATANH": "atanhf({a})",
    "LOG1P": "log1pf({a})",
    "EXPM1": "expm1f({a})",
    "TO_FLOAT": "{a}",
}

# A table row with a guide: {g} the guide's offset in shared memory, {m}
# its cells and {w} its window.
_GUIDED_EMIT = {
    name: _EMIT[name][:-1] + ", s_guide + {g}, {m}, {w})" for name in _TABLE_OPS
}

# The bodies of the rows that compute in int32 or in bool (``_compute_kind``),
# with jnp's semantics on the CPU: int32 arithmetic wraps around 2^32, and
# a bool sum is a logical or, a bool product a logical and.  The
# comparisons and AND/OR read any kind as they are (``_EMIT``).
_TYPED_EMIT = {
    "i": {
        "ADD": "add_i32({a}, {b})",
        "MUL": "mul_i32({a}, {b})",
        "SUB": "sub_i32({a}, {b})",
        "MAX": "max_i32({a}, {b})",
        "MIN": "min_i32({a}, {b})",
        "FLOORDIV": "floor_divide_i32({a}, {b})",
        "MOD": "floor_mod_i32({a}, {b})",
        "POW": "pow_i32({a}, {b})",
        "NEG": "neg_i32({a})",
        "ABS": "abs_i32({a})",
        "FLOOR": "{a}",
        "CEIL": "{a}",
        "SIGN": "sign_i32({a})",
        "SQUARE": "mul_i32({a}, {a})",
    },
    "b": {
        "ADD": "{a} || {b}",
        "MUL": "{a} && {b}",
        "MAX": "{a} || {b}",
        "MIN": "{a} && {b}",
        "ABS": "{a}",
        "FLOOR": "{a}",
        "CEIL": "{a}",
        "SIGN": "{a}",
    },
}
_ANY_KIND = (*_COMPARISONS, "AND", "OR")


def _template(name, compute):
    """The CUDA text of a row ``name`` that computes in kind ``compute``."""
    if compute == "f" or name in _ANY_KIND:
        return _EMIT[name]
    return _TYPED_EMIT[compute][name]


def _convert(text, kind, to):
    """``text``, a value of ``kind``, as a value of kind ``to``: int to
    float rounds to nearest even (as XLA and PyTorch convert), a bool is 1
    or 0, and any kind is true where it is not zero."""
    if kind == to:
        return text
    if to == "b":
        return f"({text} != {'0.0f' if kind == 'f' else '0'})"
    if kind == "i":
        return f"__int2float_rn({text})"
    return f"static_cast<{_CTYPE[to]}>({text})"  # a bool as 0 or 1

_KERNEL_HEAD = """\
// Generated by probabilit_tpu_torch/engine/cuda_exec.py::generate from a
// lowered plan: the whole sampling pass of one graph structure.
//
// Replaces probabilit_tpu/engine/pallas_exec.py::_make_kernel (the TPU's
// per-graph Pallas megakernel).  Like it, the kernel draws one uniform per
// distribution node and sample, pushes it through the node's inverse CDF,
// evaluates every transform in topological order, and writes only the
// kept rows: no quantile matrix and no intermediate reaches device memory.
//
// What bounds it on an H100: float32 and integer ALU work, not memory (4
// bytes a kept row and sample).  What the design does about it: the graph
// is straight-line code, every value a register; a thread owns groups of
// four consecutive samples, so each Philox4x32-10 call (counter
// (g mod 2^32, g >> 32, column, 0), g = sample >> 2) serves four samples,
// four independent chains fill the pipes, and a kept row's four values
// leave in one 16-byte store; constants are read from the kernel's
// parameter block as operands.  Table nodes (the TPU kernel's select
// trees over up to 512 knots) look q up in a copy of their tables in
// shared memory: a guide's word for cell floor(q M), then a search of a
// window that holds the cell, where the select tree evaluates the table.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

{includes}

namespace {{

using namespace sampling_math;
using namespace ppf_ops;
using namespace graph_ops;
using namespace table_ops;

constexpr int kThreads = {threads};
constexpr int kCorr = {n_corr};      // correlated variables K
constexpr int kKeep = {n_keep};      // kept rows
constexpr int kConsts = {n_consts};  // LOADK immediates, 32-bit words
constexpr int kRowPad = {row_pad};   // floats a row of A takes in shared memory
constexpr int kTableFloats = {table_floats};  // Tape.tables: dynamic shared memory
constexpr int kSlotFloats = {slot_floats};  // the Newton tier's quantiles, after the tables
constexpr int kGroups = {groups};  // groups a thread covers in a turn of the loop

// A float constant is read as k.v[j], an int32 or a bool one as the
// word's bits (__float_as_int(k.v[j])).
struct Consts {{
  float v[kConsts > 0 ? kConsts : 1];
}};

__global__ void __launch_bounds__(kThreads)
    graph_megakernel(const Consts k, const float* __restrict__ ab,
                     const float4* __restrict__ tables, uint32_t k0, uint32_t k1,
                     int64_t start, int64_t n, float* __restrict__ out,
                     int* __restrict__ nonfinite) {{
"""

# (A, b) is known only after the statistics pass, so it is a device array.
# Each block copies it into shared memory once, every row of A padded to a
# multiple of four floats: a RECOLOR row then reads it as 16-byte broadcast
# loads at constant offsets (a quarter of the loads __ldg would issue, no
# address arithmetic, and the same words serve the thread's four lanes).
_KERNEL_RECOLOR = """\
  __shared__ float4 s_a4[kCorr * kRowPad / 4];
  __shared__ float s_b[kCorr];
  float* s_a = reinterpret_cast<float*>(s_a4);
  for (int t = threadIdx.x; t < kCorr * kRowPad; t += kThreads) {
    const int i = t / kRowPad, j = t % kRowPad;
    s_a[t] = j < kCorr ? ab[i * kCorr + j] : 0.0f;
  }
  for (int t = threadIdx.x; t < kCorr; t += kThreads) s_b[t] = ab[kCorr * kCorr + t];
"""

# The tables: each block copies them into dynamic shared memory with
# 16-byte loads (kTableFloats is a multiple of 4), where every table row
# searches them.
_KERNEL_TABLES = """\
  extern __shared__ float4 s_tab4[];
  const float* s_tab = reinterpret_cast<const float*>(s_tab4);
  for (int t = threadIdx.x; t < kTableFloats / 4; t += kThreads) s_tab4[t] = tables[t];
"""

# The guides, words of the same copy (a guide's offset is a multiple of 4).
_KERNEL_GUIDES = """\
  const uint32_t* s_guide = reinterpret_cast<const uint32_t*>(s_tab4);
"""

_KERNEL_LOOP = """\
  // Groups g_first .. g_end - 1 cover samples start .. start + n - 1; when
  // start and n are multiples of 4 every group is whole and aligned.
  const bool vec = ((start | n) & 3) == 0;
  const uint64_t g_first = static_cast<uint64_t>(start) >> 2;
  const uint64_t g_end = ((static_cast<uint64_t>(start + n) - 1) >> 2) + 1;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kThreads;
  bool bad = false;
  for (uint64_t g = g_first + static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < g_end; g += stride) {
    const int64_t r0 = static_cast<int64_t>(g << 2) - start;  // lane 0's output row
"""

# A tape with Newton rows: each block keeps its Newton rows (family,
# shapes, constants), its work counter and, after the tables in dynamic
# shared memory, the quantiles it solves; kFamilies, the bits of the
# tape's Newton families, leaves every other family's code out.
_KERNEL_NEWTON = """\
  // The families of the Newton rows: the solve holds their code alone.
  constexpr unsigned kFamilies = {families};
  __shared__ newton_ops::Row s_rows[kNewtonRows];
  __shared__ int s_next;
  extern __shared__ float4 s_dyn4[];
  float* s_newton = reinterpret_cast<float*>(s_dyn4) + kTableFloats;
"""

# The loop of a tape with Newton rows: each turn of a block covers
# kThreads * kGroups groups; the block writes their Newton quantiles to
# shared memory, solves them together and runs the straight-line code on
# the values, kGroups groups a thread.  Every thread of the block is
# present for the solve; the threads past g_end of the last turn only help.
_KERNEL_LOOP_NEWTON = """\
  // Groups g_first .. g_end - 1 cover samples start .. start + n - 1; when
  // start and n are multiples of 4 every group is whole and aligned.
  const bool vec = ((start | n) & 3) == 0;
  const uint64_t g_first = static_cast<uint64_t>(start) >> 2;
  const uint64_t g_end = ((static_cast<uint64_t>(start + n) - 1) >> 2) + 1;
  constexpr uint64_t kTurn = static_cast<uint64_t>(kThreads) * kGroups;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kTurn;
  bool bad = false;
  for (uint64_t base = g_first + static_cast<uint64_t>(blockIdx.x) * kTurn; base < g_end;
       base += stride) {
    const int live_groups = static_cast<int>(g_end - base < kTurn ? g_end - base : kTurn);
    __syncthreads();  // the previous turn's reads of s_newton are done
    for (int sub = 0; sub < kGroups; ++sub) {
      const uint64_t g = base + static_cast<uint64_t>(sub) * kThreads + threadIdx.x;
{quantiles}    }
    if (threadIdx.x == 0) s_next = 0;
    __syncthreads();
    newton_ops::solve<kThreads, kGroups, kFamilies>(s_newton, s_rows, &s_next, {rows},
                                                    live_groups);
    __syncthreads();
    for (int sub = 0; sub < kGroups; ++sub) {
      const uint64_t g = base + static_cast<uint64_t>(sub) * kThreads + threadIdx.x;
      const bool live = g < g_end;
      const int64_t r0 = static_cast<int64_t>(g << 2) - start;  // lane 0's output row
"""

_KERNEL_TAIL = """\
  }
  if (bad) atomicOr(nonfinite, 1);
}

}  // namespace

// Launch on `stream` with one resident wave of blocks; returns
// cudaGetLastError() (0 on success).  `consts` is the host array of the
// kConsts LOADK immediates as 32-bit words, copied bit for bit, `ab`
// float32 (kCorr^2 + kCorr,) on the device (null when kCorr is 0),
// `tables` the kTableFloats floats of Tape.tables
// on the device, 16-byte aligned (null when there are none), `out` float32
// (kKeep, n) for samples start..start+n-1, `nonfinite` one int32 that the
// caller has zeroed.  n_consts, n_corr, n_keep and table_floats must be the
// kernel's own.
extern "C" int graph_megakernel_launch(const uint32_t* consts, int n_consts, const void* ab,
                                       int n_corr, const void* tables, int table_floats,
                                       int n_keep, uint32_t seed0, uint32_t seed1,
                                       int64_t start, int64_t n, void* out, void* nonfinite,
                                       void* stream) {
  if (n_consts != kConsts || n_corr != kCorr || n_keep != kKeep || n < 0 || start < 0 ||
      (kCorr > 0 && ab == nullptr) || table_floats != kTableFloats ||
      (kTableFloats > 0 && (tables == nullptr || reinterpret_cast<uintptr_t>(tables) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kDynamicBytes = 4 * (kTableFloats + kSlotFloats);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && kDynamicBytes > 0) {
    // Above 48 KB in all, static and dynamic, a block may hold dynamic
    // shared memory only when asked.
    err = cudaFuncSetAttribute(graph_megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDynamicBytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, graph_megakernel, kThreads,
                                                        kDynamicBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups = ((start + n - 1) >> 2) - (start >> 2) + 1;
  const int64_t wanted = (groups + kThreads * kGroups - 1) / (kThreads * kGroups);
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  Consts k;
  std::memcpy(k.v, consts, sizeof(uint32_t) * kConsts);
  graph_megakernel<<<static_cast<int>(wanted < resident ? wanted : resident), kThreads,
                     kDynamicBytes, static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<const float*>(ab), static_cast<const float4*>(tables), seed0, seed1,
      start, n, static_cast<float*>(out), static_cast<int*>(nonfinite));
  return static_cast<int>(cudaGetLastError());
}
"""


def _newton_plan(tape):
    """How ``generate`` lays out a tape's Newton rows: ``(rows, feeders,
    first)``.

    ``rows``: the Newton rows (program indices), gamma rows first, each
    its number in ``s_rows`` and its place in ``s_newton``.  ``feeders``:
    per Newton row, the rows that compute its quantile (its ``DRAW``, or
    the ``RECOLOR`` and ``NDTR`` of a correlated variable), which only it
    reads.  ``first``: the rows the turn runs before its solve, to write
    the quantiles: the feeders and what they read (a ``RECOLOR`` reads
    every score), in program order.
    """
    program = tape.program
    row_of, readers = {}, {}
    for i, row in enumerate(program):
        has_dst, fields = _register_fields(row[0])
        if has_dst:
            row_of[row[1]] = i
        for f in fields:
            if row[f] >= 0:
                readers[row[f]] = readers.get(row[f], 0) + 1
    feeders = {}
    for i in tape.newton_rows:
        chain = [row_of[program[i][2]]]
        if OPCODES[program[chain[0]][0]] == "NDTR":
            chain.insert(0, row_of[program[chain[0]][2]])
        if any(readers[program[f][1]] != 1 for f in chain):
            raise ValueError("A Newton row's quantile must be read by that row alone.")
        feeders[i] = chain
    needed = {f for chain in feeders.values() for f in chain}
    if any(OPCODES[program[f][0]] == "RECOLOR" for f in needed):
        for i, row in enumerate(program):
            if OPCODES[row[0]] == "SCORE":
                needed |= {i, row_of[row[2]]}
    rows = sorted(tape.newton_rows,
                  key=lambda i: NEWTON_KIND[NEWTON_OPS[OPCODES[program[i][0]]]] == "beta")
    return rows, feeders, sorted(needed)


def generate(tape):
    """The CUDA C++ text of ``tape``'s kernel: a pure function of the
    tape's structure (``program``, the kinds of its values, ``n_corr``,
    the kept rows and the number of constants), never of the constants'
    values.

    Every row of ``tape.program`` becomes one ``const`` of its kind a lane
    (``float``, ``int`` or ``bool``), named after its value number
    (``v7_2``: value 7, lane 2; ``z3_0``: score 3, lane 0); an operand of
    another kind than the row computes in is converted where it is read
    (``_convert``).  A ``LOADK`` row becomes no line, only the operand
    ``k.v[j]`` (``__float_as_int(k.v[j])`` for an int) wherever its value
    is read.  The text holds no array indexed at run time and prints no
    number that came from the graph's data: a table row prints its offset
    and its count of boundaries, never its values.

    A tape with Newton rows (``NEWTON_OPS``) gets the Newton tier of
    ``csrc/newton_ops.cuh`` (``_KERNEL_LOOP_NEWTON``): each turn writes
    its Newton quantiles to shared memory (the rows ``_newton_plan``
    puts first), the block solves them together (``newton_ops::solve``),
    and the straight-line code of the other rows reads the values back.
    A tape without one gets none of it.
    """
    K = tape.n_corr
    row_pad = _pad4(K)
    kind_of = {  # value number -> kind
        row[1]: kind for row, kind in zip(tape.program, tape.kinds) if kind is not None
    }
    const_of = {}  # value number -> index into the parameter block
    for row in tape.program:
        if OPCODES[row[0]] == "LOADK":
            const_of[row[1]] = len(const_of)
    newton, feeders, first = _newton_plan(tape) if tape.newton_rows else ([], {}, [])
    guide_of = {dst: guide for dst, *guide in tape.guides}
    groups = tape.newton_groups
    slot_of = {}  # a Newton row's value number -> its lanes' offsets in s_newton
    for j, i in enumerate(newton):
        slot_of[tape.program[i][1]] = [(j * groups * LANES + lane) * _THREADS
                                       for lane in range(LANES)]

    def operand(v, lane, to="f"):
        if v in const_of:
            text = _EMIT["LOADK"].format(index=const_of[v])
            if kind_of[v] != "f":
                text = f"__float_as_int({text})"
                if kind_of[v] == "b":
                    text = f"({text} != 0)"
        else:
            text = f"v{v}_{lane}"
        return _convert(text, kind_of[v], to)

    def slot(v, lane):
        """A Newton value's place in s_newton, for this thread and group."""
        return f"{slot_of[v][lane]} + sub * {LANES * _THREADS}"

    def emit_row(lines, op, dst, a, b, c, d, kind):
        name = OPCODES[op]
        if name == "LOADK":
            return
        if name == "DRAW":
            lines.append(f"const uint4 w{dst} = philox_group(g, {a}u, k0, k1);")
            for lane, word in enumerate("xyzw"):
                text = _EMIT[name].format(word=f"w{dst}.{word}")
                lines.append(f"const float v{dst}_{lane} = {text};")
        elif name == "STORE":
            lanes = ", ".join(operand(a, lane) for lane in range(LANES))
            lines.append(("if (live) " if newton else "") + _EMIT[name].format(row=dst, lanes=lanes))
        elif name == "SCORE":
            for lane in range(LANES):
                text = _EMIT[name].format(a=operand(a, lane))
                lines.append(f"const float z{dst}_{lane} = {text};")
        elif name in _TABLE_OPS:
            template = _GUIDED_EMIT[name] if dst in guide_of else _EMIT[name]
            g, m, w = guide_of.get(dst, (None, None, None))
            for lane in range(LANES):
                text = template.format(a=operand(a, lane), b=b, c=c, g=g, m=m, w=w)
                lines.append(f"const float v{dst}_{lane} = {text};")
        elif name == "RECOLOR":
            # b_i, then + A_ij z_j for j = 0..K-1: the twin's order.
            for q in range(row_pad // 4):
                lines.append(f"const float4 a{dst}_{q} = s_a4[{a * row_pad // 4 + q}];")
            for lane in range(LANES):
                terms = " + ".join(
                    f"a{dst}_{j // 4}.{'xyzw'[j % 4]} * z{j}_{lane}" for j in range(K)
                )
                text = _EMIT[name].format(b=f"s_b[{a}]", terms=terms)
                lines.append(f"const float v{dst}_{lane} = {text};")
        elif name in NEWTON_OPS:
            for lane in range(LANES):
                text = _EMIT[name].format(slot=slot(dst, lane))
                lines.append(f"const float v{dst}_{lane} = {text};")
        else:
            srcs = {f: v for f, v in zip("abcd", (a, b, c, d)) if v >= 0}
            compute = _compute_kind(name, [kind_of[v] for v in srcs.values()], kind)
            template = _template(name, compute)
            for lane in range(LANES):
                fields = {f: operand(v, lane, compute) for f, v in srcs.items()}
                lines.append(f"const {_CTYPE[kind]} v{dst}_{lane} = {template.format(**fields)};")

    hoisted = {f for chain in feeders.values() for f in chain}
    lines = []
    for i, (row, kind) in enumerate(zip(tape.program, tape.kinds)):
        if i not in hoisted:
            emit_row(lines, *row, kind)
    table_floats = tape.tables.numel()
    head = _KERNEL_HEAD.format(
        threads=_THREADS, n_corr=K, n_keep=tape.n_keep, n_consts=len(const_of), row_pad=row_pad,
        table_floats=table_floats, slot_floats=tape.slot_floats, groups=max(groups, 1),
        includes="\n".join(f'#include "{h}"' for h in _HEADERS),
    )
    copies = ((_KERNEL_RECOLOR if K else "") + (_KERNEL_TABLES if table_floats else "")
              + (_KERNEL_GUIDES if tape.guides else ""))
    if not newton:
        body = "".join(f"    {line}\n" for line in lines)
        if copies:
            copies += "  __syncthreads();\n"
        return head + copies + _KERNEL_LOOP + body + _KERNEL_TAIL

    # The quantiles of the turn's Newton rows, written before its solve.
    quantiles = []
    for i in first:
        emit_row(quantiles, *tape.program[i], tape.kinds[i])
    for i in newton:
        q, dst = tape.program[i][2], tape.program[i][1]
        for lane in range(LANES):
            quantiles.append(f"s_newton[{slot(dst, lane)} + threadIdx.x] = {operand(q, lane)};")
    families = sorted({NEWTON_OPS[OPCODES[tape.program[i][0]]] for i in newton},
                      key=list(INCOMPLETE_FAMILY_CAPS).index)
    copies += _KERNEL_NEWTON.replace("kNewtonRows", str(len(newton))).replace(
        "{families}", " | ".join(f"(1u << newton_ops::{_NEWTON_FAMILY_ID[f]})" for f in families))
    for j, i in enumerate(newton):
        family = NEWTON_OPS[OPCODES[tape.program[i][0]]]
        shapes = [v for v in tape.program[i][3:] if v >= 0]
        if any(v not in const_of for v in shapes):
            raise ValueError(f"A {family} row's shape parameters must be constants.")
        s0, s1 = ([operand(v, 0) for v in shapes] + ["0.0f", "0.0f"])[:2]
        copies += (f"  if (threadIdx.x == {j % _THREADS}) s_rows[{j}] = "
                   f"newton_ops::make_row<kFamilies>(newton_ops::{_NEWTON_FAMILY_ID[family]}, "
                   f"{s0}, {s1});\n")
    copies += "  __syncthreads();\n"
    loop = _KERNEL_LOOP_NEWTON.replace("{rows}", str(len(newton))).replace(
        "{quantiles}", "".join(f"      {line}\n" for line in quantiles))
    body = "".join(f"      {line}\n" for line in lines) + "    }\n"
    return head + copies + loop + body + _KERNEL_TAIL


# Each Newton family's name in csrc/newton_ops.cuh's enum Family.
_NEWTON_FAMILY_ID = {family: f"kFam{family.capitalize()}" for family in INCOMPLETE_FAMILY_CAPS}


def seed_words(seed):
    """The kernel's two Philox key words from an integer seed."""
    seed = int(seed)
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


def philox_uniforms(seed_words, n, d, device="cpu", columns=None, start=0):
    """The ``(n, d)`` float32 uniforms the kernels draw: column ``c`` of
    sample ``i`` is word ``i & 3`` of Philox4x32-10 at counter
    ``(g mod 2^32, g >> 32, c, 0)``, ``g = i >> 2``, under key
    ``seed_words``: one call per group of four samples and column.

    ``columns`` (default ``range(d)``) picks the columns; ``start`` the
    first sample index ``i``.  Neither ``start`` nor ``n`` need be a
    multiple of 4: the first and the last group are cut to the rows asked
    for.
    """
    columns = range(d) if columns is None else columns
    first = start // LANES
    g = torch.arange(first, -(-(start + n) // LANES), dtype=torch.int64, device=device)
    lo, hi = g & 0xFFFFFFFF, g >> 32
    skip = start - first * LANES
    cols = [
        _philox.bits_to_open_unit(
            torch.stack(_philox.philox4x32_10((lo, hi, c, 0), seed_words), dim=1)
        ).reshape(-1)[skip : skip + n]
        for c in columns
    ]
    if not cols:
        return torch.empty((n, 0), dtype=torch.float32, device=device)
    return torch.stack(cols, dim=1)


# The twin's ppf per opcode: a family's row is its ppf at the default loc
# (and scale), its standard variate.
_PPF_FN = {op: _ppf.lookup(family) for family, op in _FAMILY_OPS.items()}
_SCORE_FAMILY = {op: family for family, op in _SCORE_OPS.items()}


def _check_ab(tape, ab):
    if tape.n_corr and (ab is None or tuple(ab.shape) != (tape.n_corr**2 + tape.n_corr,)):
        raise ValueError(
            f"A tape with {tape.n_corr} correlated variables needs the "
            "recolour transform ab (recolor_transform) of "
            f"{tape.n_corr**2 + tape.n_corr} floats."
        )


def run_tape(tape, U, ab=None):
    """Interpret ``tape`` on the float32 quantile matrix ``U`` with PyTorch
    ops; returns the ``(n_keep, n)`` float32 outputs.  ``ab`` is the
    recolour transform of a correlated tape (``recolor_transform``)."""
    return _interpret(tape, tape.code.cpu().tolist(), tape.n_slots, U, ab)


def run_program(tape, U, ab=None):
    """``run_tape`` on the value-numbered ``tape.program``, the rows the
    generated kernel is written from, one slot per value: the same
    arithmetic in the same order, so the two agree bitwise."""
    return _interpret(tape, tape.program, len(tape.program), U, ab)


def _table_row(name, tables, off, nb, q):
    """A table row of the twin: ``torch.searchsorted`` on the float32
    table at ``off`` with ``nb`` boundaries (``table_data``'s layouts), and
    the interval's arithmetic in float32, one rounding per operation, as
    ``csrc/table_ops.cuh`` computes it.  A NaN quantile gives NaN."""
    bounds = tables[off : off + nb]
    data = tables[off + _pad4(nb) :]
    qc = q.contiguous()
    if name == "TABLE_CDF":
        count = torch.searchsorted(bounds, qc).to(torch.float32)
        return torch.where(torch.isnan(q), q, count)
    right = torch.searchsorted(bounds, qc, right=True)
    if name == "TABLE_DISCRETE":
        return torch.where(torch.isnan(q), q, data[right])
    leaf = data[: 4 * (nb + 1)].reshape(nb + 1, 4)[right]
    value = leaf[:, 1] + (q - leaf[:, 0]) * leaf[:, 2]
    x_last, f_last = data[4 * (nb + 1)], data[4 * (nb + 1) + 1]
    return torch.where(q >= x_last, f_last, value)


def _interpret(tape, code, n_slots, U, ab):
    """The rows of ``code`` on typed slots: a constant is a tensor of its
    kind, a transform is the plain executor's own op on typed tensors, the
    other rows read their operands as float32, and ``STORE`` casts to
    float32, as the kernel's rows do."""
    if config.float_dtype() != torch.float32:
        raise ValueError("The tape is float32-only.")
    _check_ab(tape, ab)
    tables = tape.tables.to(U.device)
    imm = tape.imm.cpu().tolist()
    K = tape.n_corr
    ab = [] if ab is None else ab.cpu().tolist()
    n = U.shape[0]
    slots = [None] * n_slots
    z = [None] * K
    out = torch.empty((tape.n_keep, n), dtype=torch.float32, device=U.device)

    def f32(*fields):
        return [slots[s].to(torch.float32) for s in fields if s >= 0]

    for (op, dst, a, b, c, d), k, kind in zip(code, imm, tape.kinds):
        name = OPCODES[op]
        if name == "DRAW":
            slots[dst] = U[:, a].to(torch.float32)
        elif name == "LOADK":
            value = {"b": bool, "i": int, "f": float}[kind](k)
            slots[dst] = torch.full((n,), value, dtype=_DTYPE[kind], device=U.device)
        elif name == "STORE":
            out[dst] = slots[a]
        elif name == "SCORE":
            z[dst] = _special.ndtri_fast(*f32(a))
        elif name == "RECOLOR":
            # The kernel's order: b_i, then + A_ij z_j for j = 0..K-1.
            y = torch.full((n,), ab[K * K + a], dtype=torch.float32, device=U.device)
            for j in range(K):
                y = y + ab[a * K + j] * z[j]
            slots[dst] = y
        elif name == "NDTR":
            slots[dst] = clamp_open_unit(_special.ndtr_fast(*f32(a)))
        elif name == "AFFINE":
            x, loc, scale = f32(a, b, c)
            slots[dst] = loc + scale * x
        elif name in _TABLE_OPS:
            slots[dst] = _table_row(name, tables, b, c, *f32(a))
        elif name in _SCORE_FAMILY:
            slots[dst] = _ppf.score_call(_SCORE_FAMILY[name], *f32(a, b, c, d))
        elif name in _PPF_FN:
            with _special.kernel_safe_special():  # the kernel's own functions
                slots[dst] = _PPF_FN[name](*f32(a, b, c, d))
        elif name == "TO_FLOAT":
            slots[dst] = slots[a].to(torch.float32)
        else:
            slots[dst] = _TRANSFORM_FN[name](*(slots[s] for s in (a, b) if s >= 0))
    return out


def run_reference(tape, seed_words, n, ab=None, start=0):
    """The plain twin of the kernel: the same bits, the same tape."""
    U = philox_uniforms(seed_words, n, tape.d, device=tape.code.device, start=start)
    return run_tape(tape, U, ab)


def run(tape, seed_words, n, ab=None, start=0):
    """Sample rows ``start .. start + n - 1`` of ``tape``; returns
    ``(out, nonfinite)``.

    ``out`` is ``(n_keep, n)`` float32 on the tape's device; ``nonfinite``
    is an int32 tensor, nonzero when any stored value is not finite.  A
    correlated tape takes its recolour transform ``ab`` (float32
    ``(K^2 + K,)``, from ``recolor_transform``).  A CPU tape runs the plain
    version; a CUDA tape launches its generated kernel, which the first
    launch of a new graph structure builds with nvcc (``tape.kernel``).  A
    build or a launch that fails raises.
    """
    global LAUNCHES
    with _profiling.span("probabilit.k1"):
        device = tape.code.device
        _check_ab(tape, ab)
        if device.type == "cpu":
            out = run_reference(tape, seed_words, n, ab, start)
            return out, (~torch.isfinite(out)).any().to(torch.int32).reshape(1)
        issue = environment_issue(device)
        if issue is not None:
            raise RuntimeError(issue)
        if (
            tape.n_instr > MAX_INSTR or len(tape.consts) > MAX_CONSTS or tape.n_keep > MAX_KEEP
            or tape.n_corr > MAX_CORR_K or tape.shared_bytes > MAX_SHARED_BYTES
        ):
            raise ValueError("The tape exceeds the kernel's caps.")
        if tape.tables.device != device or tape.tables.dtype != torch.float32:
            raise ValueError("The tape's tables must be float32 on the tape's device.")
        if start < 0 or n < 0:
            raise ValueError(f"start and n must be >= 0, got {start} and {n}.")
        launch = tape.kernel
        if tape.n_corr:
            ab = ab.to(device=device, dtype=torch.float32).contiguous()
        out = torch.empty((tape.n_keep, n), dtype=torch.float32, device=device)
        flag = torch.zeros((1,), dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            err = launch(
                tape.const_block, len(tape.consts),
                ab.data_ptr() if tape.n_corr else None, tape.n_corr,
                tape.tables.data_ptr() if tape.tables.numel() else None, tape.tables.numel(),
                tape.n_keep,
                seed_words[0], seed_words[1], start, n,
                out.data_ptr(), flag.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"graph_megakernel launch failed: CUDA error {err}.")
        LAUNCHES += 1
        return out, flag


def _megakernel(source):
    from probabilit_tpu_torch import _build

    fn = _build.load_generated("graph_megakernel", source, _HEADERS).graph_megakernel_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _stats_width(k):
    """Sums per row of statistics: z_k, then z_j z_k for j <= k."""
    return k + k * (k + 1) // 2


def corr_stats_reference(seed_words, n, columns, device="cpu", chunk=1 << 22, start=0):
    """The plain twin of the statistics kernel: float64 ``(P,)`` sums of
    z_k and of z_j z_k (upper triangle, row-major) over the samples
    ``start <= i < start + n``, with z = ``ndtri_fast`` of the kernel's
    uniforms of ``columns``."""
    k = len(columns)
    iu = torch.triu_indices(k, k, device=device)
    sums = torch.zeros(_stats_width(k), dtype=torch.float64, device=device)
    for offset in range(0, n, chunk):
        rows = min(chunk, n - offset)
        U = philox_uniforms(
            seed_words, rows, k, device=device, columns=columns, start=start + offset
        )
        z = _special.ndtri_fast(U).double()
        sums[:k] += z.sum(dim=0)
        sums[k:] += (z.T @ z)[iu[0], iu[1]]
    return sums


def corr_stats(seed_words, n, columns, device, start=0):
    """The statistics of ``columns`` over samples ``start .. start + n - 1``,
    float64 ``(P,)``.

    On the CPU the plain twin; on a CUDA device the kernel
    (``csrc/corr_stats.cu``), whose per-block float64 partials are summed
    on the device.
    """
    global STATS_LAUNCHES
    with _profiling.span("probabilit.k2"):
        device = torch.device(device)
        if device.type == "cpu":
            return corr_stats_reference(seed_words, n, columns, device, start=start)
        issue = environment_issue(device)
        if issue is not None:
            raise RuntimeError(issue)
        k = len(columns)
        if not 1 <= k <= MAX_CORR_K or n <= 0 or start < 0:
            raise ValueError(f"corr_stats takes 1..{MAX_CORR_K} columns, n > 0 and start >= 0.")
        blocks = stats_grid(k, n)
        cols = (ctypes.c_int * k)(*(int(c) for c in columns))  # a launch parameter, not a copy
        partials = torch.empty((blocks, _stats_width(k)), dtype=torch.float64, device=device)
        err = _stats_kernel().corr_stats_launch(
            cols, k, seed_words[0], seed_words[1], start, n,
            partials.data_ptr(), blocks,
            torch.cuda.current_stream(device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"corr_stats launch failed: CUDA error {err}.")
        STATS_LAUNCHES += 1
        return partials.sum(dim=0)


def stats_grid(k, n):
    """Blocks (rows of partials) the statistics kernel uses for k columns
    and n samples on the current card: one resident wave."""
    blocks = ctypes.c_int(0)
    err = _stats_kernel().corr_stats_grid(k, n, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"corr_stats_grid failed: CUDA error {err}.")
    return blocks.value


def stats_blocks_per_sm(k):
    """Blocks of the statistics kernel for k columns that one SM of the
    current card holds at once (256 threads each)."""
    per_sm = ctypes.c_int(0)
    err = _stats_kernel().corr_stats_blocks_per_sm(k, ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"corr_stats_blocks_per_sm failed: CUDA error {err}.")
    return per_sm.value


def _stats_kernel():
    from probabilit_tpu_torch import _build

    lib = _build.load("corr_stats")
    lib.corr_stats_grid.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    lib.corr_stats_grid.restype = ctypes.c_int
    lib.corr_stats_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.corr_stats_blocks_per_sm.restype = ctypes.c_int
    lib.corr_stats_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.corr_stats_launch.restype = ctypes.c_int
    return lib


def solve_recolor(sums, n, corr_matrix):
    """The recolour transform from the score statistics, in float64 numpy
    (the twin of ``solve_recolor_device``).

    Returns ``[A row-major, b]`` (numpy float64) such that
    ``y_i = b_i + sum_j A_ij z_j`` standardises the scores, removes their
    empirical correlation and colours them to ``corr_matrix``: the same
    map as ``ImanConover._recolor_scores``, from moments instead of the
    scores themselves.  The target factor comes from
    ``Correlator.set_target``, so a PSD-singular target raises its
    ``ValueError``.
    """
    sums = np.asarray(sums, dtype=np.float64)
    k = corr_matrix.shape[0]
    P = _correlation.ImanConover().set_target(corr_matrix).P
    mean = sums[:k] / n
    G = np.zeros((k, k))
    G[np.triu_indices(k)] = sums[k:]
    G = G + np.triu(G, 1).T
    cov = G / n - np.outer(mean, mean)
    std = np.sqrt(np.diag(cov))
    L = np.linalg.cholesky(cov / np.outer(std, std))
    A = (P @ np.linalg.solve(L, np.eye(k))) / std[None, :]
    b = -A @ mean
    return np.concatenate([A.ravel(), b])


def solve_recolor_device(sums, n, target_factor):
    """``solve_recolor`` in float64 torch ops on the device of ``sums``.

    ``target_factor`` is the lower Cholesky factor ``P`` of the target
    (``ImanConover().set_target(C).P``).  Nothing here waits for the
    card: ``cholesky_ex`` does not check its result, so a singular
    empirical correlation (a degenerate sample) gives NaNs, which the
    megakernel's non-finite flag reports.
    """
    k = target_factor.shape[0]
    mean = sums[:k] / n
    iu = torch.triu_indices(k, k, device=sums.device)
    G = torch.zeros((k, k), dtype=torch.float64, device=sums.device)
    G[iu[0], iu[1]] = sums[k:]
    G = G + torch.triu(G, 1).T
    cov = G / n - torch.outer(mean, mean)
    std = torch.sqrt(torch.diagonal(cov))
    L, _ = torch.linalg.cholesky_ex(cov / torch.outer(std, std))
    eye = torch.eye(k, dtype=torch.float64, device=sums.device)
    P = torch.as_tensor(target_factor, dtype=torch.float64, device=sums.device)
    A = (P @ torch.linalg.solve_triangular(L, eye, upper=False)) / std[None, :]
    b = -A @ mean
    return torch.cat([A.reshape(-1), b])


def recolor_transform(plan, seed_words, n, device=None, start=0, solve="host"):
    """Run the statistics pass over the plan's correlated columns for
    samples ``start .. start + n - 1`` and solve the recolour transform:
    float32 ``(K^2 + K,)`` on ``device`` (default ``config.device()``).
    The counterpart of ``pallas_exec._recolor_transform``.

    ``solve="host"`` copies the sums to the host and solves in numpy (the
    path's one sync); ``solve="device"`` solves in torch ops on ``device``
    and never waits for it.
    """
    device = config.device() if device is None else torch.device(device)
    if solve not in ("host", "device"):
        raise ValueError(f"solve must be 'host' or 'device', got {solve!r}.")
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    sums = corr_stats(seed_words, n, columns, device, start=start)
    with _profiling.span("probabilit.solve"):
        if solve == "device":
            P = _correlation.ImanConover().set_target(plan.corr_matrix).P  # raises if singular
            return solve_recolor_device(sums, n, P).to(torch.float32)
        with _profiling.span("probabilit.wait"):
            sums = sums.cpu().numpy()
        ab = solve_recolor(sums, n, plan.corr_matrix)
        return torch.tensor(ab, dtype=torch.float32, device=device)


# The fold kernel's kinds of y (``YKind`` in csrc/block_fold.cu): a
# control is float32 or float64, a condition also bool/uint8 or int32.
_FOLD_Y_KINDS = {
    torch.float32: 1, torch.float64: 2, torch.bool: 3, torch.uint8: 3, torch.int32: 4,
}
# The fields of a streamed estimate's 13-field carry
# (``streaming._estimate_carry``) that the fold kernel keeps in one
# float64 buffer, in the buffer's order (``Field`` in csrc/block_fold.cu):
# n, mean, M2, min, max, finite, my, M2y, Cxy, M3, M4.
PACKED_FIELDS = (0, 1, 2, 3, 4, 5, 7, 8, 9, 11, 12)
FOLD_FIELDS = len(PACKED_FIELDS)


def pack_moments(carry, device=None):
    """The moment fields of a 13-field carry as one float64 tensor
    (``finite`` as 1.0 or 0.0), on ``device`` (default: the carry's)."""
    packed = torch.stack([carry[i].to(torch.float64) for i in PACKED_FIELDS])
    return packed if device is None else packed.to(device)


def unpack_moments(packed, qsum, hsum):
    """The 13-field carry whose moment fields are views of ``packed``
    (``finite`` a bool), with the quantile sums and histogram counts."""
    n, mean, m2, vmin, vmax, finite, my, m2y, cxy, m3, m4 = packed.unbind()
    return (n, mean, m2, vmin, vmax, finite != 0, qsum, my, m2y, cxy, hsum, m3, m4)


def fold_scratch(device):
    """The fold kernel's scratch for one call on ``device``: float64
    partials (``FOLD_FIELDS``, capacity), one column per CTA of a launch,
    and the zeroed uint32 ticket that picks the CTA which finishes it."""
    device = torch.device(device)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _fold_kernel().block_fold_capacity(ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"block_fold_capacity failed: CUDA error {err}.")
    partials = torch.empty((FOLD_FIELDS, blocks.value), dtype=torch.float64, device=device)
    return partials, torch.zeros((1,), dtype=torch.int32, device=device)


def _aligned(t):
    """``t``, or a copy of it where its storage is not 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def block_fold(carry, x, y, cnt, where_mode, moments, scratch):
    """Fold samples ``0 .. cnt - 1`` of the float32 block ``x`` into the
    packed carry in place: the fold kernel (``csrc/block_fold.cu``).

    ``carry`` is a ``pack_moments`` buffer, float64 ``(FOLD_FIELDS,)``.  ``y``
    is the control (read as float64) or, with ``where_mode``, the
    condition (nonzero accepts), or None; ``moments`` adds M3 and M4.
    ``scratch`` is ``fold_scratch(device)``.  A control that is neither
    float32 nor float64 becomes float64, a condition of another dtype
    ``y != 0`` (one launch).  Takes CUDA tensors only, and raises on what
    the kernel does not take.
    """
    global FOLD_LAUNCHES
    device = carry.device
    partials, ticket = scratch
    if device.type != "cuda":
        raise ValueError(
            "block_fold runs on a CUDA device; on the CPU the fold is "
            "streaming._block_moments and streaming._merge."
        )
    if carry.dtype != torch.float64 or carry.shape != (FOLD_FIELDS,) or not carry.is_contiguous():
        raise ValueError(f"The packed carry must be contiguous float64 ({FOLD_FIELDS},).")
    if x.dtype != torch.float32 or x.dim() != 1 or x.device != device:
        raise ValueError("block_fold folds a 1-D float32 block on the carry's device.")
    if not 0 < cnt <= x.numel():
        raise ValueError(f"cnt must lie in 1..{x.numel()}, got {cnt}.")
    if partials.device != device or ticket.device != device:
        raise ValueError("The scratch must lie on the carry's device.")
    if where_mode and y is None:
        raise ValueError("where_mode folds under a condition y.")
    kind = 0
    if y is not None:
        if y.dim() != 1 or y.numel() < cnt or y.device != device:
            raise ValueError(f"y must be 1-D with at least {cnt} entries on the carry's device.")
        if where_mode and y.dtype not in _FOLD_Y_KINDS:
            y = y != 0
        elif not where_mode and y.dtype not in (torch.float32, torch.float64):
            y = y.to(torch.float64)
        y = _aligned(y.contiguous())
        kind = _FOLD_Y_KINDS[y.dtype]
    x = _aligned(x.contiguous())
    with torch.cuda.device(device):
        err = _fold_kernel().block_fold_launch(
            x.data_ptr(), None if y is None else y.data_ptr(), kind, int(bool(where_mode)),
            int(bool(moments)), cnt, carry.data_ptr(), partials.data_ptr(), partials.shape[1],
            ticket.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block_fold launch failed: CUDA error {err}.")
    FOLD_LAUNCHES += 1


@functools.lru_cache(maxsize=None)
def _fold_kernel():
    from probabilit_tpu_torch import _build

    lib = _build.load("block_fold")
    lib.block_fold_capacity.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.block_fold_capacity.restype = ctypes.c_int
    lib.block_fold_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.block_fold_launch.restype = ctypes.c_int
    return lib
