"""``device_idle_pct``'s reading in a cell whose calls the host paces, which moves
that cell's own throughput metric."""

from mcbench import spec

read = spec.reader("device_idle_pct")
