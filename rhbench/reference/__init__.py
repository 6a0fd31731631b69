"""The benchmark's plain reference mapper: NumPy and plain PyTorch on the
CPU, importing nothing of the port.  It is a frozen copy of the port's plain
path as it stood when the benchmark was defined (the events stage's plain
versions, the plain sketch, the host index build, the plain chaining fill,
the host backtrack, compaction, regions, MAPQ and the mapping decision),
run read by read without capacities, so that the records the port's timed
path produces can be held against it."""
