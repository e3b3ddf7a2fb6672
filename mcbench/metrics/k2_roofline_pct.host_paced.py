"""``k2_roofline_pct``'s reading in a cell whose calls the host paces, which moves
that cell's own throughput metric."""

from mcbench import spec

read = spec.reader("k2_roofline_pct")
