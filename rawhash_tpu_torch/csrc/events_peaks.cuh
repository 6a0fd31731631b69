// The event detector's dual peak detector (reference: gen_peaks,
// revent.c:107-145), one read's steps, shared by the CUDA kernel
// (events_peaks.cu) and a host build of the same logic
// (events_peaks_host.cpp, which the CPU tests build with g++).
//
// It is signal/events.py::_gen_peaks_plain a position at a time: two
// detectors a read over the two t-statistics (the short window's and the
// long window's); while the short detector sits on a peak above its
// threshold it resets the long one and masks it up to that peak + w1.
// Each position emits the short then the long detector's peak position, or
// -1.  The short detector never reads the long one, so it runs as its own
// step (rh_peaks_short), which emits its peak and a handoff word for the
// position; the long detector's step (rh_peaks_long) consumes the word.
// The kernel runs the two steps on two warps, the long one a tile of
// positions behind; the host build runs a tile of short steps, then the
// tile's long steps.  The steps only compare, select and subtract f32
// values, so every build gives the plain version's positions bit for bit
// on finite t-statistics (the events stage's are finite and >= +0).
#pragma once

#include <float.h>
#include <limits.h>

#ifdef __CUDACC__
#define RH_PK_HD __host__ __device__ __forceinline__
#else
#define RH_PK_HD static inline
#endif

// the handoff word of a position where the short detector does not mask
// the long one
#define RH_PK_NO_MASK INT_MIN

// one detector's state: the candidate peak's position (-1: none yet), its
// value (FLT_MAX before the first minimum), and whether it has dropped by
// more than peak_height below the peak
struct RhPeakDet {
  int pos;
  float val;
  bool valid;
};

// t1, t2: the thresholds; ph: peak_height; w1: the short window (the mask's
// reach); half1, half2: w1 // 2 and w2 // 2, how far past a peak a
// detector emits it
struct RhPeakParams {
  float t1, t2, ph;
  int w1, half1, half2;
};

RH_PK_HD RhPeakDet rh_peak_fresh() {
  RhPeakDet d = {-1, FLT_MAX, false};
  return d;
}

// One position of one detector (events.py::_detector_step): updates *d if
// active; returns the emitted peak position or -1, and in *mask whether the
// detector sits on a peak above its threshold (at *mask_pos).
//
// The plain step's two cases, written so that the carried value's chain
// is short: `higher` (cur > val) picks the peak's new maximum (pv2 = cur,
// pp2 = i) or keeps it, and every later test is taken on the case it
// picks instead of on the selected value: the drop pv2 - cur is cur - cur
// = 0 or val - cur, "above" is cur > thr or val > thr, and the age i - pp2
// is 0 or i - pos.  On finite values each is the plain step's own test, so
// the state and the emissions are the same bit for bit.  The new value is
// one select of cur or val.
RH_PK_HD int rh_peak_detector(RhPeakDet* d, float cur, int i, bool active,
                              float thr, int half, float ph, bool* mask,
                              int* mask_pos) {
  const int pos = d->pos;
  const float val = d->val;
  const bool in_peak = pos >= 0;
  const bool higher = cur > val;
  const bool deeper = cur < val;
  // case 1 (no maximum yet): the signal rose more than ph above the minimum
  const bool rise = !deeper && (cur - val) > ph;
  // case 2 (inside a candidate peak)
  const bool above = higher ? cur > thr : val > thr;
  const bool dropped = higher ? 0.0f > ph : (val - cur) > ph;
  const bool valid2 = d->valid || (dropped && above);
  const bool aged = higher ? 0 > half : (i - pos) > half;
  const bool emit = valid2 && aged;
  const int pp2 = higher ? i : pos;
  // selects, not branches: the lanes of a warp take different cases
  const bool peak = active && in_peak, flat = active && !in_peak;
  const bool take = peak ? (emit || higher) : (flat && (deeper || rise));
  d->val = take ? cur : val;
  d->pos = peak ? (emit ? -1 : pp2) : (flat && rise ? i : pos);
  d->valid = peak ? valid2 && !emit : d->valid;
  *mask = peak && above;
  *mask_pos = pp2;
  return peak && emit ? pp2 : -1;
}

// The short detector at position i on cur1 (active: i < n and i > 0):
// *e0, its emission; returns the handoff word: mask_pos + w1 where it masks
// the long detector (reset it, masked up to that position), else
// RH_PK_NO_MASK.
RH_PK_HD int rh_peaks_short(RhPeakDet* d0, float cur1, int i, bool active,
                            const RhPeakParams& P, int* e0) {
  bool mask;
  int mask_pos;
  *e0 = rh_peak_detector(d0, cur1, i, active, P.t1, P.half1, P.ph, &mask,
                         &mask_pos);
  return mask ? mask_pos + P.w1 : RH_PK_NO_MASK;
}

// The long detector at position i on cur2 (alive: i < n), after the short
// detector's handoff word for i (revent.c:125-131: its peak resets the long
// detector and masks it up to the word); *masked_to, the position up to
// which it is masked, carries.  Returns its emission.
RH_PK_HD int rh_peaks_long(RhPeakDet* d1, int* masked_to, float cur2, int i,
                           bool alive, int hand, const RhPeakParams& P) {
  const bool reset = hand != RH_PK_NO_MASK;
  *masked_to = reset ? hand : *masked_to;
  d1->pos = reset ? -1 : d1->pos;
  d1->val = reset ? FLT_MAX : d1->val;
  d1->valid = !reset && d1->valid;
  bool unused;
  int unused_pos;
  return rh_peak_detector(d1, cur2, i, alive && *masked_to < i, P.t2, P.half2,
                          P.ph, &unused, &unused_pos);
}
