"""Parallel context (world size 1 so far)."""
