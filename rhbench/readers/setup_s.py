"""Set-up: from the process's start to the first timed batch handed over
(imports, the card's context, kernel libraries, genome, index, read pool
and warm-up)."""


def read(ctx):
    return ctx["setup_s"]
