"""A call whose answer is its statistics, folded over its blocks
(``estimate``): ``n``, ``mean``, ``std``, ``sem``, ``min``, ``max``, and
the quantiles and CVaRs its mix asks for."""

from mcbench import compare, reference


def reference_answer(cell, s, device, arith="float64"):
    """The plain reference's statistics for the call with ``random_state`` ``s``."""
    options = cell.traffic["options"]
    return reference.estimate(
        reference.Graph(cell.config), s, cell.size, int(options["block_size"]), device,
        reference.Arithmetic(arith), options.get("quantiles", ()), options.get("cvar", ()),
    )


def numbers(cell, answer, ref):
    return compare.stream_numbers(answer, ref, cell.traffic)
