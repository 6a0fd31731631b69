"""Profiling of the port on the card: the fill-loop-overhead probe
(`fill_loop_overhead`) and the bounds every kernel time is held against
(`bounds`)."""
