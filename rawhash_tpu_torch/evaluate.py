"""Mapping-accuracy evaluation against a ground-truth PAF (port of
rawhash_tpu/evaluate.py).

Re-implements the reference's evaluation methodology (SURVEY.md §4):
  * reference `test/scripts/pafstats.py:12-57` — (read, target) pair
    classification vs a minimap2 ground-truth PAF into tp/fp/fn/tn, plus
    throughput stats from the `mt:f:` (ms to map) and `sl:i:` (sequenced
    signals) PAF tags;
  * reference `test/scripts/compare_pafs.py:17-62` — precision / recall /
    F-1 and mean/median time-per-read from annotated PAFs.

Differences from the reference scripts (deliberate):
  * the reference's read_paf drops the first PAF line from the accuracy
    counts (it `continue`s after discovering the mt column on line 0,
    pafstats.py:30-38) — we count every line;
  * results come back as a dict (and one JSON line from the CLI) instead of
    free-text stderr, so the bench can gate on them.

Classification semantics (pafstats.py:60-79): a pair (query, target) is
  tp — mapped by the tool AND mapped by the truth to the same target
  fp — mapped by the tool, not in the truth's mapped set
  fn — in the truth's mapped set, not mapped by the tool
  tn — in neither mapped set (i.e. both emitted unmapped records)
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field


@dataclass
class PafRead:
    """Per-record PAF fields the evaluator consumes."""

    query: str
    qlen: int
    target: str  # '*' when unmapped
    tstart: int = 0
    tend: int = 0
    strand: str = "*"
    mt_ms: float | None = None  # mt:f: tag (ms to map)
    sl: int | None = None  # sl:i: tag (sequenced signals)
    line: str = ""


def parse_paf(path_or_lines):
    """Parse a PAF file (path or iterable of lines) into PafRead records.

    Tag columns (mt:f:, sl:i:) are discovered per line by prefix, like the
    reference discovers them dynamically (pafstats.py:30-36)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            return parse_paf(f.readlines())
    out = []
    for line in path_or_lines:
        line = line.rstrip("\n")
        if not line:
            continue
        cols = line.split("\t")
        if len(cols) < 12:
            cols = line.split()
        if len(cols) < 6:
            continue
        mt = sl = None
        for c in cols[12:]:
            if c.startswith("mt:f:"):
                mt = float(c[5:])
            elif c.startswith("sl:i:"):
                sl = int(c[5:])
        try:
            tstart = int(cols[7]) if cols[7] != "*" else 0
            tend = int(cols[8]) if cols[8] != "*" else 0
        except (ValueError, IndexError):
            tstart = tend = 0
        out.append(
            PafRead(
                query=cols[0],
                qlen=int(cols[1]) if cols[1] != "*" else 0,
                target=cols[5],
                tstart=tstart,
                tend=tend,
                strand=cols[4] if len(cols) > 4 else "*",
                mt_ms=mt,
                sl=sl,
                line=line,
            )
        )
    return out


@dataclass
class EvalResult:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    tn: int = 0
    precision: float = 0.0
    recall: float = 0.0
    f1: float = 0.0
    mean_mt_ms: float = 0.0
    median_mt_ms: float = 0.0
    mean_bps: float = 0.0
    median_bps: float = 0.0
    mean_sps: float = 0.0
    median_sps: float = 0.0
    annotations: list = field(default_factory=list)  # (query, target, 'tp'..)

    def as_dict(self):
        return {
            k: getattr(self, k)
            for k in (
                "tp", "fp", "fn", "tn", "precision", "recall", "f1",
                "mean_mt_ms", "median_mt_ms", "mean_bps", "median_bps",
                "mean_sps", "median_sps",
            )
        }


def evaluate_paf(input_paf, truth_paf) -> EvalResult:
    """Classify the tool PAF against the ground-truth PAF and compute
    precision/recall/F1 + per-read throughput stats.

    `input_paf` / `truth_paf`: paths, iterables of lines, or lists of
    PafRead.  Mirrors reference pafstats.py:60-79 (set-of-pairs
    classification) and compute_throughput (pafstats.py:85-99: bp/s =
    1000*qlen/mt per first record of each read)."""
    inp = input_paf if _is_reads(input_paf) else parse_paf(input_paf)
    tru = truth_paf if _is_reads(truth_paf) else parse_paf(truth_paf)

    in_mapped = {(r.query, r.target) for r in inp if r.target != "*"}
    in_unmapped = {(r.query, r.target) for r in inp if r.target == "*"}
    tr_mapped = {(r.query, r.target) for r in tru if r.target != "*"}
    tr_unmapped = {(r.query, r.target) for r in tru if r.target == "*"}
    tr_mapped_reads = {q for q, _ in tr_mapped}

    res = EvalResult()
    all_pairs = in_mapped | in_unmapped | tr_mapped | tr_unmapped
    for pair in sorted(all_pairs):
        if pair in in_mapped:
            if pair in tr_mapped:
                res.tp += 1
                res.annotations.append((*pair, "tp"))
            else:
                res.fp += 1
                res.annotations.append((*pair, "fp"))
        elif pair in tr_mapped:
            res.fn += 1
            res.annotations.append((*pair, "fn"))
        else:
            res.tn += 1
            res.annotations.append((*pair, "tn"))

    res.precision = res.tp / (res.tp + res.fp) if res.tp + res.fp else 0.0
    res.recall = res.tp / (res.tp + res.fn) if res.tp + res.fn else 0.0
    denom = 2 * res.tp + res.fp + res.fn
    res.f1 = 2 * res.tp / denom if denom else 0.0

    # throughput stats: first record of each read only (pafstats.py:46-53)
    seen = set()
    mts, bps, sps = [], [], []
    for r in inp:
        if r.query in seen or r.mt_ms is None:
            continue
        seen.add(r.query)
        mts.append(r.mt_ms)
        if r.mt_ms > 0:
            bps.append(1000.0 * r.qlen / r.mt_ms)
            if r.sl is not None:
                sps.append(1000.0 * r.sl / r.mt_ms)
    if mts:
        res.mean_mt_ms = statistics.mean(mts)
        res.median_mt_ms = statistics.median(mts)
    if bps:
        res.mean_bps = statistics.mean(bps)
        res.median_bps = statistics.median(bps)
    if sps:
        res.mean_sps = statistics.mean(sps)
        res.median_sps = statistics.median(sps)
    return res


def _is_reads(x):
    return isinstance(x, list) and x and isinstance(x[0], PafRead)


def annotate_paf(input_paf, truth_paf):
    """Yield each input PAF line with an `rf:Z:{tp,fp,fn,tn}` tag appended
    (the `uncalled pafstats -r truth --annotate` flow the reference's
    comparison scripts consume, compare_pafs.py:17-62)."""
    inp = parse_paf(input_paf) if not _is_reads(input_paf) else input_paf
    res = evaluate_paf(inp, truth_paf)
    cls = {(q, t): c for q, t, c in res.annotations}
    for r in inp:
        tag = cls.get((r.query, r.target))
        yield f"{r.line}\trf:Z:{tag}" if tag else r.line


def location_overlap(input_paf, truth_paf, slop: int = 0) -> dict:
    """Stricter positional agreement: a mapped record is location-correct if
    truth maps the read to the same target AND [tstart,tend] overlaps the
    truth interval (± slop).  Not part of the reference scripts (they match
    on target name only) — used by our synthetic benches where exact truth
    intervals are known."""
    inp = parse_paf(input_paf) if not _is_reads(input_paf) else input_paf
    tru = parse_paf(truth_paf) if not _is_reads(truth_paf) else truth_paf
    tr = {}
    for r in tru:
        if r.target != "*":
            tr.setdefault(r.query, []).append(r)
    n_loc = n_mapped = 0
    for r in inp:
        if r.target == "*":
            continue
        n_mapped += 1
        for t in tr.get(r.query, []):
            if (
                t.target == r.target
                and r.tstart <= t.tend + slop
                and t.tstart <= r.tend + slop
            ):
                n_loc += 1
                break
    return {
        "mapped": n_mapped,
        "location_correct": n_loc,
        "location_accuracy": n_loc / n_mapped if n_mapped else 0.0,
    }
