"""Minimal FASTA/FASTQ reader (plain or gzip), host side.

Replaces the reference's kseq.h/bseq.c streaming parser (reference:
src/kseq.h, src/bseq.c) — the genome is read once at index-build time, so a
simple buffered Python reader is the right tool; no native code needed here.
"""

from __future__ import annotations

import gzip
from typing import Iterator


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) records; FASTA and FASTQ are auto-detected."""
    with _open(path) as fp:
        first = fp.read(1)
        if not first:
            return
        if first == "@":
            yield from _read_fastq(fp)
            return
        if first != ">":
            raise ValueError(f"{path}: not FASTA/FASTQ")
        name, parts = None, []
        line = fp.readline()
        name = line.strip().split()[0] if line.strip() else ""
        for line in fp:
            if line.startswith(">"):
                yield name, "".join(parts)
                name = line[1:].strip().split()[0]
                parts = []
            else:
                parts.append(line.strip())
        if name is not None:
            yield name, "".join(parts)


def _read_fastq(fp) -> Iterator[tuple[str, str]]:
    # first '@' already consumed by the caller
    name = fp.readline().strip().split()[0]
    while True:
        seq = fp.readline().strip()
        fp.readline()  # '+'
        fp.readline()  # quals
        yield name, seq
        hdr = fp.readline()
        if not hdr:
            return
        name = hdr[1:].strip().split()[0]
