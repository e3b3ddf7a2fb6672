"""``exposed_host_ms_per_call``'s reading in a cell whose calls the host paces, which moves
that cell's own throughput metric."""

from mcbench import spec

read = spec.reader("exposed_host_ms_per_call")
