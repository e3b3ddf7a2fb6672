"""Graph nodes, distributions and benchmark models."""
