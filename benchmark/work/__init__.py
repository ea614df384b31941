"""Frozen operation and byte counts, fixed by the shapes alone."""
