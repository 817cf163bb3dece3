"""Readers of the benchmark metrics, one file a metric (loaded by path)."""
