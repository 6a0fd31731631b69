"""A stage's seconds over the window (the growth of the engine's
StageProfiler total for the stage), in ms per 1000 read-chunks (the sum of
the window's reads' ci).  The stage's marks synchronise its batch's stream,
so its time is its own batch's; with several batches in flight the stages'
sums can pass the wall time.  None where the stage did not run."""


def read(ctx, stage: str):
    s = ctx["stages"].get(stage, 0.0)
    if s <= 0.0 or ctx["chunks"] <= 0:
        return None
    return s * 1e3 / (ctx["chunks"] / 1e3)
