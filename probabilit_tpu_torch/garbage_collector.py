"""Eager ``.samples_`` release during host-driven topological sampling.

The port's copy of ``probabilit_tpu/garbage_collector.py``.  The engine
does not use it: ``build_body`` keeps only the requested outputs and
drops every other value after its last child.  The class is for users who
drive a graph by hand, assigning ``node.samples_`` in topological order.

A node's samples may be released once every graph edge pointing at it has
been consumed, i.e. all of its children have been sampled.  Edge counts
are path-multiplicity-aware, as a census over the duplicate-revisiting
``Node.nodes()`` traversal would give, but computed in O(V + E) by
propagating multiplicities over the unique graph.
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Collection

__all__ = ["GarbageCollector"]


class GarbageCollector:
    """Release ``.samples_`` as soon as every consumer of a node has run.

    Parameters
    ----------
    strategy : None or collection of nodes
        ``None`` disables collection (every node keeps its samples).  A
        collection lists nodes to *protect*; everything else is released
        once fully consumed.  ``[]`` therefore frees all intermediates,
        leaving only the sink (which has no consumers).
    """

    def __init__(self, strategy=None):
        if strategy is not None and not isinstance(strategy, Collection):
            raise TypeError(f"`strategy` must be None or a collection, got: {strategy}")
        self.strategy = strategy

    def set_sink(self, sink):
        """Register the output node and take the edge census of its graph:
        a parent's count is the number of sink-to-parent paths ending in
        each of its child edges."""
        self.sink = sink
        if self.strategy is not None:
            from probabilit_tpu_torch.models.graph import topological_sort

            mult = Counter({sink: 1})  # sink-to-node path counts
            edges = Counter()
            for node in reversed(topological_sort(sink)):
                m = mult[node]
                for parent in node.get_parents():
                    edges[parent] += m
                    mult[parent] += m
            self._edges_left = edges
        return self

    def decrement_and_delete(self, node):
        """Record that ``node`` has been sampled; release exhausted parents.

        Every parent edge of ``node`` is consumed.  A parent whose edge
        count hits zero and is not protected by the strategy loses its
        ``samples_`` attribute.  Returns the nodes released by this call.
        """
        if not hasattr(self, "sink"):
            raise ValueError("You must call 'set_sink' first.")
        if self.strategy is None:
            return []

        released = []
        for parent in node.get_parents():
            self._edges_left[parent] -= 1
            remaining = self._edges_left[parent]
            assert remaining >= 0, "node sampled more often than it has consumers"
            if remaining == 0 and parent not in self.strategy:
                del parent.samples_
                released.append(parent)
        return released
