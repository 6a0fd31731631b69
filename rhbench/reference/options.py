"""The mapping parameters of a preset (RawHash2's ri_set_opt and
ri_idxopt_init / ri_mapopt_init defaults), for the presets the benchmark's
configurations name; a frozen copy of the port's config.py values."""

from __future__ import annotations

DEFAULTS = dict(
    # index side
    w=0, e=8, q=4, k=6, diff=0.35, fine_min=-2.0, fine_max=2.0, fine_range=0.4,
    # device constants
    bp_per_sec=450, sample_rate=4000, chunk_size=4000,
    # seeding
    mid_occ_frac=1e-2, min_mid_occ=50, max_mid_occ=500_000,
    # chaining
    min_events=50, bw=500, max_target_gap_length=2500,
    max_query_gap_length=2500, max_chain_iter=200, min_num_anchors=2,
    min_chaining_score=15, chain_gap_scale=0.8, chain_skip_scale=0.0,
    # the decision
    w_bestq=0.35, w_bestmq=0.05, w_bestmc=0.6, w_threshold=0.45,
    mask_level=0.5, mask_len=2**31 - 1, pri_ratio=0.3, best_n=0, alt_drop=0.15,
    max_num_chunk=10, min_mapq=2,
    # event detector
    window_length1=3, window_length2=9, threshold1=4.0, threshold2=3.5,
    peak_height=0.4,
    # events kept per chunk (the port's max_events_per_chunk)
    e_cap=768,
)

PRESETS = {
    "viral": dict(e=6, bw=100, max_target_gap_length=500,
                  max_query_gap_length=500, max_num_chunk=5,
                  min_chaining_score=10, chain_gap_scale=1.2,
                  chain_skip_scale=0.3),
    "sensitive": {},
}


def options(preset: str) -> dict:
    """The parameters of `preset`, with the derived ones: the seed span,
    samples per base and the chaining penalties (RawHash2's rmap.cpp:318,
    rounded as float32)."""
    import numpy as np

    o = dict(DEFAULTS)
    o.update(PRESETS[preset])
    o["span"] = o["k"] + o["e"] - 1
    o["sample_per_base"] = float(o["sample_rate"]) / float(o["bp_per_sec"])
    f = np.float32
    o["chn_pen_gap"] = float(f(o["chain_gap_scale"]) * f(0.01) * f(o["span"]))
    o["chn_pen_skip"] = float(f(o["chain_skip_scale"]) * f(0.01) * f(o["span"]))
    return o
