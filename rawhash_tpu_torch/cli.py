"""Command line: the reference's flag surface (build_parser and
options_from_args, as rawhash_tpu/cli.py defines them) plus --device.

    python -m rawhash_tpu_torch [options] <target.fa|index> [signal files...]
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import (
    IndexFlag,
    IndexOptions,
    MapFlag,
    MapOptions,
    apply_depletion,
    apply_r10,
    set_preset,
)
from .map.pipeline import run_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rawhash-tpu-torch",
        description="raw nanopore signal mapper (PyTorch/CUDA engine)",
        add_help=True,
    )
    p.add_argument("target", help="reference FASTA or prebuilt index (.rhi.npz)")
    p.add_argument("query", nargs="*", help="signal files/dirs (FAST5/POD5/SLOW5)")
    p.add_argument("-x", dest="preset", default=None, help="preset")
    p.add_argument("-d", dest="dump_index", default=None, help="dump index to FILE")
    p.add_argument("-p", dest="pore_file", default=None, help="pore model FILE")
    p.add_argument("-k", type=int, default=None, help="pore k-mer size")
    p.add_argument("-e", type=int, default=None, help="events per seed")
    p.add_argument("-q", type=int, default=None, help="quantization bits")
    p.add_argument("-w", type=int, default=None, help="minimizer window")
    p.add_argument("-n", type=int, default=None)
    p.add_argument("-t", dest="threads", type=int, default=3)
    p.add_argument("-K", dest="mini_batch", default=None)
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("--level_column", type=int, default=None)
    p.add_argument("--q-mid-occ", default=None)
    p.add_argument("--mid_occ_frac", "--occ-frac", dest="occ_frac", type=float,
                   default=None)
    p.add_argument("--min-events", type=int, default=None)
    p.add_argument("--bw", type=int, default=None)
    p.add_argument("--max-target-gap", type=int, default=None)
    p.add_argument("--max-query-gap", type=int, default=None)
    p.add_argument("--min-anchors", type=int, default=None)
    p.add_argument("--min-score", type=int, default=None)
    p.add_argument("--min-score2", type=int, default=None)
    p.add_argument("--chain-gap-scale", type=float, default=None)
    p.add_argument("--chain-skip-scale", type=float, default=None)
    p.add_argument("--best-chains", type=int, default=None)
    p.add_argument("--primary-ratio", type=float, default=None)
    p.add_argument("--primary-length", type=int, default=None)
    p.add_argument("--max-skips", type=int, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--rmq", action="store_true")
    p.add_argument("--rmq-inner-dist", type=int, default=None)
    p.add_argument("--rmq-size-cap", type=int, default=None)
    p.add_argument("--bw-long", type=int, default=None)
    p.add_argument("--max-chunks", type=int, default=None)
    p.add_argument("--min-mapq", type=int, default=None)
    p.add_argument("--alt-drop", type=float, default=None)
    p.add_argument("--w-besta", type=float, default=None)
    p.add_argument("--w-bestma", type=float, default=None)
    p.add_argument("--w-bestq", type=float, default=None)
    p.add_argument("--w-bestmq", type=float, default=None)
    p.add_argument("--w-bestmc", type=float, default=None)
    p.add_argument("--w-threshold", type=float, default=None)
    p.add_argument("--bp-per-sec", type=int, default=None)
    p.add_argument("--sample-rate", type=int, default=None)
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--seg-window-length1", type=int, default=None)
    p.add_argument("--seg-window-length2", type=int, default=None)
    p.add_argument("--seg-threshold1", type=float, default=None)
    p.add_argument("--seg-threshold2", type=float, default=None)
    p.add_argument("--seg-peak-height", type=float, default=None)
    p.add_argument("--sequence-until", action="store_true")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--n-samples", type=int, default=None)
    p.add_argument("--test-frequency", type=int, default=None)
    p.add_argument("--min-reads", type=int, default=None)
    p.add_argument("--depletion", action="store_true")
    p.add_argument("--store-sig", action="store_true")
    p.add_argument("--sig-target", action="store_true")
    p.add_argument("--disable-adaptive", action="store_true")
    p.add_argument("--sig-diff", type=float, default=None)
    p.add_argument("--align", action="store_true")
    p.add_argument("--dtw-evaluate-chains", action="store_true")
    p.add_argument("--dtw-output-cigar", action="store_true")
    p.add_argument("--dtw-border-constraint", default=None,
                   choices=["global", "sparse", "local"])
    p.add_argument("--dtw-log-scores", action="store_true")
    p.add_argument("--no-chainingscore-filtering", action="store_true")
    p.add_argument("--dtw-match-bonus", type=float, default=None)
    p.add_argument("--output-chains", action="store_true")
    p.add_argument("--dtw-fill-method", default=None)
    p.add_argument("--dtw-min-score", type=float, default=None)
    p.add_argument("--r10", action="store_true")
    p.add_argument("--fine-min", type=float, default=None)
    p.add_argument("--fine-max", type=float, default=None)
    p.add_argument("--fine-range", type=float, default=None)
    p.add_argument("--out-quantize", action="store_true")
    p.add_argument("--no-event-detection", action="store_true")
    p.add_argument("--no-rev-target", action="store_true")
    # debug/observability flags (reference: main.cpp:70-72); the reference
    # defines the bits (roptions.h:30-31) and the limit (roptions.c:104) but
    # its pipeline never consumes them (the only use, rmap.cpp:270, is
    # commented out) — we accept and store them for 1:1 flag-surface parity
    p.add_argument("--log-anchors", action="store_true")
    p.add_argument("--log-num-anchors", action="store_true")
    p.add_argument("--rev-collision-count", type=int, default=None)
    p.add_argument("--io-thread", type=int, default=1)
    p.add_argument("--batch-reads", type=int, default=None,
                   help="device batch size (TPU engine)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="read batches in flight (device/host overlap)")
    p.add_argument("--max-anchors", type=int, default=None,
                   help="initial per-read anchor capacity (TPU engine; grows "
                        "on overflow up to --max-anchor-cap)")
    p.add_argument("--max-anchor-cap", type=int, default=None,
                   help="ceiling for overflow-retry anchor growth "
                        "(0 disables growth)")
    p.add_argument("--n-shards", type=int, default=None,
                   help="shard the seed table over a (dp, shard) device mesh "
                        "(TPU scale-out; 1 = pure data parallelism)")
    p.add_argument("--version", action="version", version="rawhash-tpu 0.1 (parity: RawHash2 2.1)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device the mapping runs on (default: cuda)")
    return p


def parse_num(s: str) -> int:
    mult = 1
    if s and s[-1] in "GgMmKk":
        mult = {"g": 10**9, "m": 10**6, "k": 10**3}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult + 0.499)


def options_from_args(args) -> tuple[IndexOptions, MapOptions]:
    io = IndexOptions()
    mo = MapOptions()
    set_preset(args.preset, io, mo)  # presets first (reference: main.cpp:274)
    if args.r10:
        apply_r10(io, mo)
    if args.depletion:
        apply_depletion(mo)

    def idx(attr, val):
        if val is not None:
            setattr(io, attr, val)

    def mp(attr, val):
        if val is not None:
            setattr(mo, attr, val)

    idx("k", args.k); idx("e", args.e); idx("q", args.q); idx("w", args.w)
    idx("n", args.n)
    idx("lev_col", args.level_column)
    idx("diff", args.sig_diff)
    idx("fine_min", args.fine_min); idx("fine_max", args.fine_max)
    idx("fine_range", args.fine_range)
    for a, b_ in (("window_length1", args.seg_window_length1),
                  ("window_length2", args.seg_window_length2),
                  ("threshold1", args.seg_threshold1),
                  ("threshold2", args.seg_threshold2),
                  ("peak_height", args.seg_peak_height)):
        idx(a, b_); mp(a, b_)
    if args.bp_per_sec is not None:
        io.bp_per_sec = mo.bp_per_sec = args.bp_per_sec
    if args.sample_rate is not None:
        io.sample_rate = mo.sample_rate = args.sample_rate

    if args.q_mid_occ:
        parts = args.q_mid_occ.split(",")
        mo.min_mid_occ = int(parts[0])
        if len(parts) > 1:
            mo.max_mid_occ = int(parts[1])
    mp("mid_occ_frac", args.occ_frac)
    mp("min_events", args.min_events)
    mp("bw", args.bw)
    mp("max_target_gap_length", args.max_target_gap)
    mp("max_query_gap_length", args.max_query_gap)
    mp("min_num_anchors", args.min_anchors)
    mp("min_chaining_score", args.min_score)
    mp("min_chaining_score2", args.min_score2)
    mp("chain_gap_scale", args.chain_gap_scale)
    mp("chain_skip_scale", args.chain_skip_scale)
    mp("best_n", args.best_chains)
    mp("mask_level", args.primary_ratio)
    mp("mask_len", args.primary_length)
    mp("max_num_skips", args.max_skips)
    mp("max_chain_iter", args.max_iterations)
    mp("rmq_inner_dist", args.rmq_inner_dist)
    mp("rmq_size_cap", args.rmq_size_cap)
    mp("bw_long", args.bw_long)
    mp("max_num_chunk", args.max_chunks)
    mp("min_mapq", args.min_mapq)
    mp("alt_drop", args.alt_drop)
    mp("w_besta", args.w_besta)
    mp("w_bestma", args.w_bestma)
    mp("w_bestq", args.w_bestq)
    mp("w_bestmq", args.w_bestmq)
    mp("w_bestmc", args.w_bestmc)
    mp("w_threshold", args.w_threshold)
    mp("chunk_size", args.chunk_size)
    mp("t_threshold", args.threshold)
    mp("tn_samples", args.n_samples)
    mp("ttest_freq", args.test_frequency)
    mp("tmin_reads", args.min_reads)
    mp("dtw_match_bonus", args.dtw_match_bonus)
    mp("dtw_min_score", args.dtw_min_score)
    mp("batch_reads", args.batch_reads)
    mp("pipeline_depth", args.pipeline_depth)
    mp("max_anchors_per_read", args.max_anchors)
    mp("max_anchor_cap", args.max_anchor_cap)
    mp("n_shards", args.n_shards)
    if args.mini_batch:
        mo.mini_batch_size = parse_num(args.mini_batch)

    if args.rmq:
        mo.flag |= MapFlag.RMQ
    if args.log_anchors:
        mo.flag |= MapFlag.LOG_ANCHORS
    if args.log_num_anchors:
        mo.flag |= MapFlag.LOG_NUM_ANCHORS
    mp("rev_col_limit", args.rev_collision_count)
    if args.sequence_until:
        mo.flag |= MapFlag.SEQUENCEUNTIL
    if args.disable_adaptive:
        mo.flag |= MapFlag.NO_ADAPTIVE
    if args.align:
        mo.flag |= MapFlag.ALIGN
    if args.dtw_evaluate_chains:
        mo.flag |= MapFlag.DTW_EVALUATE_CHAINS
    if args.dtw_output_cigar:
        mo.flag |= MapFlag.DTW_OUTPUT_CIGAR
    if args.dtw_log_scores:
        mo.flag |= MapFlag.DTW_LOG_SCORES
    if args.no_chainingscore_filtering:
        mo.flag |= MapFlag.DISABLE_CHAININGSCORE_FILTERING
    if args.output_chains:
        mo.flag |= MapFlag.OUTPUT_CHAINS
    if args.store_sig:
        io.flag |= IndexFlag.STORE_SIG
    if args.sig_target:
        io.flag |= IndexFlag.SIG_TARGET
    if args.no_rev_target:
        io.flag |= IndexFlag.NO_REV_TARGET
    if args.out_quantize:
        io.flag |= IndexFlag.OUT_QUANTIZE | IndexFlag.SIG_TARGET
    if args.no_event_detection:
        io.flag |= IndexFlag.NO_EVENT_DETECTION
    if args.dtw_border_constraint:
        from .config import DtwBorderConstraint

        mo.dtw_border_constraint = {
            "global": DtwBorderConstraint.GLOBAL,
            "sparse": DtwBorderConstraint.SPARSE,
            "local": DtwBorderConstraint.LOCAL,
        }[args.dtw_border_constraint]
    if args.dtw_fill_method:
        from .config import DtwFillMethod

        if args.dtw_fill_method.startswith("banded"):
            mo.dtw_fill_method = DtwFillMethod.BANDED
            if args.dtw_fill_method.startswith("banded="):
                mo.dtw_band_radius_frac = float(args.dtw_fill_method[7:])
        elif args.dtw_fill_method == "full":
            mo.dtw_fill_method = DtwFillMethod.FULL
    return io, mo


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    io, mo = options_from_args(args)
    if args.device == "cuda" and args.query:
        import torch

        if mo.max_chain_iter < 1:
            print("[ERROR] --device cuda: --max-iterations must be at least 1",
                  file=sys.stderr)
            return 1
        if not torch.cuda.is_available():
            print("[ERROR] --device cuda: no CUDA device is available "
                  "(use --device cpu)", file=sys.stderr)
            return 1
    return run_pipeline(args, io, mo, time.time(), args.device)


if __name__ == "__main__":
    sys.exit(main())
