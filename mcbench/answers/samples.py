"""A call whose answer is its samples (``sample``), compared one by one."""

import torch

from mcbench import compare, reference


def reference_answer(cell, s, device, arith="float64"):
    """The plain reference's samples for the call with ``random_state``
    ``s``, as a list of (start, values) blocks."""
    graph = reference.Graph(cell.config)
    return list(reference.sample_blocks(graph, s, cell.size, device, reference.Arithmetic(arith)))


def numbers(cell, answer, ref):
    """The gaps of ``answer`` (a tensor, or (start, values) blocks of the
    same starts as ``ref``) against the reference's blocks."""
    blocks = None if isinstance(answer, torch.Tensor) else dict(answer)
    gap = compare.SampleGap()
    for start, r in ref:
        gap.add(answer[start : start + r.numel()] if blocks is None else blocks[start], r)
    return gap.numbers()
