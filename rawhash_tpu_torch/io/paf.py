"""PAF output (port of rawhash_tpu/io/paf.py; reference: rmap.cpp:736-798)."""

from __future__ import annotations

from ..index.build import RawIndex
from ..map.engine import ReadResult


def paf_lines(result: ReadResult, index: RawIndex):
    """Yield PAF lines for one read's mapping records.

    Mapped:   name qlen qs qe strand ref rlen rs re matches blocklen mapq tags
    Unmapped: name qlen  *  *      *   *    *  *  *       *        * mapq tags
    """
    for m in result.records:
        if m.mapped and m.ref_id < index.n_seq:
            yield (
                f"{result.name}\t{m.read_length}\t{m.read_start}\t{m.read_end}\t"
                f"{'-' if m.rev else '+'}\t{index.seq_names[m.ref_id]}\t"
                f"{int(index.seq_lens[m.ref_id])}\t{m.frag_start}\t"
                f"{m.frag_start + m.frag_len}\t"
                f"{m.read_end - m.read_start - 1}\t{m.frag_len}\t{m.mapq}\t{m.tags}"
            )
        elif not m.mapped:
            yield (
                f"{result.name}\t{m.read_length}\t*\t*\t*\t*\t*\t*\t*\t*\t*\t"
                f"{m.mapq}\t{m.tags}"
            )


def write_paf(results, index: RawIndex, fp) -> None:
    for res in results:
        for line in paf_lines(res, index):
            fp.write(line + "\n")
