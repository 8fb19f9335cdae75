"""Partition specs for parameters and caches, activation constraints, and
the mesh axes the collective merges read."""
