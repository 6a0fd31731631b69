"""Throughput: bases of signal the window's reads consumed (each read's
chunks ci x chunk_size / samples per base) over the window's wall time,
from the first batch handed over to the last batch's results."""


def read(ctx):
    return ctx["bases"] / ctx["window_s"]
