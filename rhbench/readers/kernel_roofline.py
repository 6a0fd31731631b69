"""A kernel's share of its roofline in the traced window: the sum of its
launches' bounds (the larger of bytes over the memory rate and operations
over their rates, rhbench/bounds.py, worked out on each launch's own
inputs) over the sum of their device times in the profiler's trace, in %.
Only launches whose inputs were kept and whose kernel the trace linked to
the call count.  None where there is none: never 0."""


def read(ctx, kernel: str):
    pairs = ctx["rooflines"].get(kernel) or []
    spent = sum(t for _, t in pairs)
    if not pairs or spent <= 0:
        return None
    return 100.0 * sum(b for b, _ in pairs) / spent
