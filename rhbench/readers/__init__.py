"""Readers of the benchmark's metrics: readers/<name>.py has
`read(ctx, **params)`, which takes one metric from what a run recorded
(`ctx`: the window's bases, chunks and latencies, set-up time, stage
seconds, the trace's summary and the kernels' bounds) or returns None
when the run holds nothing to read; the harness then leaves the metric
out.  A metric's file (metrics/<metric>.json) names its reader and the
reader's parameters."""
