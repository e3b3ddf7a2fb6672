"""CUDA megakernel executor: the whole graph in one hand-written kernel.

The port's counterpart of ``probabilit_tpu/engine/pallas_exec.py``.  The
TPU kernel is specialised per graph by tracing ``Node._emit`` inside
Pallas; a per-graph ``nvcc`` build would cost seconds for every new graph.
So one compiled kernel (``csrc/graph_megakernel.cu``) interprets a small
*tape* that ``lower`` makes from the plan:

* an ``int32 (n_instr, 6)`` array of ``[opcode, dst, a, b, c, d]`` rows;
* an ``f32 (n_instr,)`` immediate per row (the value of ``LOADK``).

Opcodes: ``DRAW`` (one uniform column from Philox4x32-10), ``LOADK``, one
per ppf family (parameters are slots, so Node-valued parameters work),
one per transform (variadic chains fold left, as ``functools.reduce``
does), and ``STORE k``.  Values live in per-thread slots, reused by
liveness.

``run`` is the wrapper: on a tape whose tensors lie on the CPU it uses the
plain version (``run_reference``); on a CUDA tape it launches the kernel,
counting the launch in ``LAUNCHES``, or raises.  ``run_reference`` is
``philox_uniforms`` (the same random bits as the kernel) followed by
``run_tape`` (the same tape, interpreted with PyTorch ops on float32).
"""

from __future__ import annotations

import ctypes
import inspect
import itertools
import math
import numbers
from dataclasses import dataclass

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.models import graph as _graph
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.ops import philox as _philox
from probabilit_tpu_torch.ops import ppf as _ppf

__all__ = [
    "LAUNCHES",
    "supports",
    "environment_issue",
    "keep_order",
    "lower",
    "seed_words",
    "philox_uniforms",
    "run_tape",
    "run_reference",
    "run",
]

# Launches of the CUDA kernel by ``run``.
LAUNCHES = 0

# MAX_SLOTS and MAX_INSTR must equal kMaxSlots and kMaxInstr in
# csrc/graph_megakernel.cu; MAX_KEEP is the 16 outputs of pallas_exec.supports.
MAX_SLOTS = 64
MAX_INSTR = 1024
MAX_KEEP = 16
_THREADS = 256

_FAMILY_OPS = {
    "uniform": "PPF_UNIFORM",
    "norm": "PPF_NORM",
    "expon": "PPF_EXPON",
    "lognorm": "PPF_LOGNORM",
    "triang": "PPF_TRIANG",
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

# Opcode numbering; the enum in csrc/graph_megakernel.cu lists the same
# names in the same order.
OPCODES = (
    ["DRAW", "LOADK", "STORE"]
    + list(_FAMILY_OPS.values())
    + list(_TRANSFORM_OPS.values())
)
_OPCODE = {name: i for i, name in enumerate(OPCODES)}

# The tape computes in float32, which is what the JAX package computes for
# float operands.  Integer and boolean operands follow jnp's integer
# arithmetic there (int32 wrap-around, integer powers and floor division,
# bool + bool = logical or), so a transform whose operands are all
# integer or bool is refused unless its result is float-valued anyway or
# it is a logical All/Any.
_FLOAT_VALUED = (
    _graph.Avg, _graph.Divide, _graph.Arctan2, _graph.Log, _graph.Exp,
    _graph.Sqrt, _graph.Log10, _graph.Sin, _graph.Cos, _graph.Tan,
    _graph.Arcsin, _graph.Arccos, _graph.Arctan, _graph.Sinh, _graph.Cosh,
    _graph.Tanh, _graph.Arcsinh, _graph.Arccosh, _graph.Arctanh,
    _graph.Log1p, _graph.Expm1,
)
_LOGICAL = (_graph.All, _graph.Any)
_COMPARISONS = (
    _graph.Equal, _graph.NotEqual, _graph.LessThan, _graph.LessThanOrEqual,
    _graph.GreaterThan, _graph.GreaterThanOrEqual, _graph.IsClose,
)


def _has_integer_arithmetic(plan):
    """True if a transform computes on integer or bool operands only and
    jnp gives it an integer or bool result (see above)."""
    kinds = {}  # node_id -> "f", "i" or "b", as jnp types the node
    for node in plan.topo:
        if isinstance(node, _graph.Constant):
            value = node.value
            kinds[node._id] = (
                "b" if isinstance(value, bool)
                else "i" if isinstance(value, numbers.Integral) else "f"
            )
            continue
        if isinstance(node, Distribution):
            kinds[node._id] = "f"
            continue
        parent_kinds = {kinds[p._id] for p in node.get_parents()}
        if isinstance(node, _FLOAT_VALUED):
            kinds[node._id] = "f"
        elif isinstance(node, _LOGICAL):
            kinds[node._id] = "b"
        elif "f" not in parent_kinds:
            return True
        else:
            kinds[node._id] = "b" if isinstance(node, _COMPARISONS) else "f"
    return False


def _ppf_params(node):
    """The node's ppf parameters after ``q``, in signature order, defaults
    filled in (numbers or Nodes)."""
    sig = inspect.signature(_ppf.lookup(node.distr))
    bound = sig.bind(None, *node.args, **node.kwargs)
    bound.apply_defaults()
    return list(bound.arguments.values())[1:]


def _structure_ok(plan, keep_ids):
    """Can every node and the keep-set be expressed on the tape?"""
    if plan.corr_vars:
        return False  # Correlated graphs: the next slice (ROADMAP A6).
    topo_ids = {node._id for node in plan.topo}
    if plan.sink._id not in keep_ids or not keep_ids <= topo_ids:
        return False
    if len(keep_ids) > MAX_KEEP:
        return False
    for node in plan.topo:
        if isinstance(node, _graph.Constant):
            if not isinstance(node.value, numbers.Real):
                return False
        elif isinstance(node, Distribution):
            if node.distr not in _FAMILY_OPS:
                return False
            try:
                _ppf_params(node)
            except TypeError:
                return False
        elif type(node) not in _TRANSFORM_OPS and not isinstance(node, _graph.Avg):
            return False  # NoOp and node types without a kernel op.
    return not _has_integer_arithmetic(plan)


def supports(plan, keep_ids):
    """True if this graph can run as the CUDA megakernel.

    The counterpart of ``pallas_exec.supports`` restricted to what the
    port has: uncorrelated graphs of Constants, the five closed-form
    families and the arithmetic transforms, with at most 16 kept nodes
    including the sink, no ``NoOp``, no integer or boolean arithmetic, and
    a tape within the kernel's instruction and slot caps.
    """
    keep_ids = frozenset(keep_ids)
    if not _structure_ok(plan, keep_ids):
        return False
    try:
        lower(plan, keep_order(plan, keep_ids))  # the tape's size caps
    except ValueError:
        return False
    return True


def environment_issue(device=None):
    """None if the kernel can run on ``device`` (default
    ``config.device()``), else the reason it cannot."""
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

    code: torch.Tensor  # int32 (n_instr, 6): [opcode, dst, a, b, c, d]
    imm: torch.Tensor  # float32 (n_instr,)
    n_slots: int
    d: int  # uniform columns drawn
    keep_order: tuple  # node ids of the output rows

    @property
    def n_instr(self):
        return self.code.shape[0]

    @property
    def n_keep(self):
        return len(self.keep_order)

    def to(self, device):
        return Tape(
            self.code.to(device), self.imm.to(device), self.n_slots, self.d,
            self.keep_order,
        )


def lower(plan, keep_order):
    """Turn ``plan`` into a ``Tape`` whose ``STORE k`` rows write the nodes
    of ``keep_order``; raises ``ValueError`` on a graph ``supports`` refuses.

    Values are first numbered one per instruction, then mapped onto slots:
    a slot is free again after the last instruction that reads it.
    """
    if not _structure_ok(plan, frozenset(keep_order)):
        raise ValueError("This graph is not supported by the CUDA megakernel.")
    rows = []  # [op, dst, a, b, c, d, imm]; dst and a..d are value numbers
    new_value = itertools.count()
    value_of = {}

    def emit(op, srcs=(), imm=0.0):
        v = next(new_value)
        srcs = list(srcs) + [-1] * (4 - len(srcs))
        rows.append([_OPCODE[op], v, *srcs, imm])
        return v

    def operand(x):
        return value_of[x._id] if isinstance(x, _graph.Node) else emit("LOADK", imm=x)

    for node in plan.topo:
        if isinstance(node, _graph.Constant):
            v = emit("LOADK", imm=node.value)
        elif isinstance(node, Distribution):
            q = emit("DRAW")
            rows[-1][2] = plan.col_of[node._id]  # a: the column (a literal)
            params = [operand(p) for p in _ppf_params(node)]
            v = emit(_FAMILY_OPS[node.distr], [q, *params])
        elif isinstance(node, _graph.Avg):
            vals = [value_of[p._id] for p in node.parents]
            acc = vals[0]
            for x in vals[1:]:
                acc = emit("ADD", [acc, x])
            v = emit("DIV", [acc, emit("LOADK", imm=len(vals))])
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
        rows.append([_OPCODE["STORE"], k, value_of[nid], -1, -1, -1, 0.0])

    code, n_slots = _allocate_slots(rows)
    imm = np.array([float(r[6]) for r in rows], dtype=np.float32)
    tape = Tape(
        torch.from_numpy(code), torch.from_numpy(imm), n_slots, plan.d,
        tuple(keep_order),
    )
    if tape.n_instr > MAX_INSTR or tape.n_slots > MAX_SLOTS:
        raise ValueError(
            f"The tape needs {tape.n_instr} instructions and {tape.n_slots} "
            f"slots; the kernel holds {MAX_INSTR} and {MAX_SLOTS}."
        )
    return tape


def _register_fields(op):
    """(dst is a value, operand fields that are values) for an opcode."""
    name = OPCODES[op]
    if name == "DRAW":
        return True, ()  # a is a column number
    if name == "LOADK":
        return True, ()
    if name == "STORE":
        return False, (2,)  # dst is the output row
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


def seed_words(seed):
    """The kernel's two Philox key words from an integer seed."""
    seed = int(seed)
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


def philox_uniforms(seed_words, n, d, device="cpu"):
    """The ``(n, d)`` float32 uniforms the kernel draws: column ``c`` of
    sample ``i`` is word 0 of Philox4x32-10 at counter
    ``(i mod 2^32, i >> 32, c, 0)`` under key ``seed_words``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    lo, hi = i & 0xFFFFFFFF, i >> 32
    cols = [
        _philox.bits_to_open_unit(_philox.philox4x32_10((lo, hi, c, 0), seed_words)[0])
        for c in range(d)
    ]
    if not cols:
        return torch.empty((n, 0), dtype=torch.float32, device=device)
    return torch.stack(cols, dim=1)


_PPF_FN = {op: _ppf.lookup(family) for family, op in _FAMILY_OPS.items()}
_OP_FN = {op: cls.op for cls, op in _TRANSFORM_OPS.items()}


def run_tape(tape, U):
    """Interpret ``tape`` on the float32 quantile matrix ``U`` with PyTorch
    ops; returns the ``(n_keep, n)`` float32 outputs."""
    if config.float_dtype() != torch.float32:
        raise ValueError("The tape is float32-only.")
    code = tape.code.cpu().tolist()
    imm = tape.imm.cpu().tolist()
    n = U.shape[0]
    slots = [None] * tape.n_slots
    out = torch.empty((tape.n_keep, n), dtype=torch.float32, device=U.device)
    for (op, dst, a, b, c, d), k in zip(code, imm):
        name = OPCODES[op]
        if name == "DRAW":
            slots[dst] = U[:, a].to(torch.float32)
        elif name == "LOADK":
            slots[dst] = torch.full((n,), k, dtype=torch.float32, device=U.device)
        elif name == "STORE":
            out[dst] = slots[a]
        elif name in _PPF_FN:
            args = [slots[s] for s in (a, b, c, d) if s >= 0]
            slots[dst] = _PPF_FN[name](*args)
        else:
            args = [slots[s] for s in (a, b) if s >= 0]
            slots[dst] = _OP_FN[name](*args).to(torch.float32)
    return out


def run_reference(tape, seed_words, n):
    """The plain twin of the kernel: the same bits, the same tape."""
    U = philox_uniforms(seed_words, n, tape.d, device=tape.code.device)
    return run_tape(tape, U)


def run(tape, seed_words, n):
    """Sample ``n`` rows of ``tape``; returns ``(out, nonfinite)``.

    ``out`` is ``(n_keep, n)`` float32 on the tape's device; ``nonfinite``
    is an int32 tensor, nonzero when any stored value is not finite.  A
    CPU tape runs the plain version; a CUDA tape launches the kernel.
    """
    global LAUNCHES
    device = tape.code.device
    if device.type == "cpu":
        out = run_reference(tape, seed_words, n)
        return out, (~torch.isfinite(out)).any().to(torch.int32).reshape(1)
    issue = environment_issue(device)
    if issue is not None:
        raise RuntimeError(issue)
    if tape.n_instr > MAX_INSTR or tape.n_slots > MAX_SLOTS or tape.n_keep > MAX_KEEP:
        raise ValueError("The tape exceeds the kernel's caps.")
    code = tape.code.to(torch.int32).contiguous()
    imm = tape.imm.to(torch.float32).contiguous()
    out = torch.empty((tape.n_keep, n), dtype=torch.float32, device=device)
    flag = torch.zeros((1,), dtype=torch.int32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(math.ceil(n / _THREADS), sms * (2048 // _THREADS)))
    err = _launcher()(
        code.data_ptr(), imm.data_ptr(), tape.n_instr,
        seed_words[0], seed_words[1], n,
        out.data_ptr(), flag.data_ptr(), blocks,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"graph_megakernel launch failed: CUDA error {err}.")
    LAUNCHES += 1
    return out, flag


def _launcher():
    from probabilit_tpu_torch import _build

    fn = _build.load("graph_megakernel").graph_megakernel_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn
