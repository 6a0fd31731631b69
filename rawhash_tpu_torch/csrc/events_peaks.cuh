// The event detector's dual peak detector (reference: gen_peaks,
// revent.c:107-145), one read's step, shared by the CUDA kernel
// (events_peaks.cu) and a host build of the same logic
// (events_peaks_host.cpp, which the CPU tests build with g++).
//
// It is signal/events.py::_gen_peaks_plain a position at a time: two
// detectors a read over the two t-statistics (the short window's and the
// long window's); while the short detector sits on a peak above its
// threshold it resets the long one and masks it up to that peak + w1.
// Each position emits the short then the long detector's peak position, or
// -1.  The step only compares, selects and subtracts f32 values, so every
// build gives the plain version's positions bit for bit.
#pragma once

#include <float.h>

#ifdef __CUDACC__
#define RH_PK_HD __host__ __device__ __forceinline__
#else
#define RH_PK_HD static inline
#endif

// one detector's state: the candidate peak's position (-1: none yet), its
// value (FLT_MAX before the first minimum), and whether it has dropped by
// more than peak_height below the peak
struct RhPeakDet {
  int pos;
  float val;
  bool valid;
};

// a read's state: both detectors, and the position up to which the short
// detector masks the long one
struct RhPeakRow {
  RhPeakDet d0, d1;
  int masked_to1;
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

RH_PK_HD RhPeakRow rh_peak_row() {
  RhPeakRow r = {rh_peak_fresh(), rh_peak_fresh(), 0};
  return r;
}

// One position of one detector (events.py::_detector_step): updates *d if
// active; returns the emitted peak position or -1, and in *mask whether the
// detector sits on a peak above its threshold (at *mask_pos).
RH_PK_HD int rh_peak_detector(RhPeakDet* d, float cur, int i, bool active,
                              float thr, int half, float ph, bool* mask,
                              int* mask_pos) {
  const bool in_peak = d->pos >= 0;
  // case 1: no recorded maximum yet; follow the minimum until a rise
  const bool c1_deeper = cur < d->val;
  const bool c1_rise = !c1_deeper && (cur - d->val) > ph;
  const float pv1 = (c1_deeper || c1_rise) ? cur : d->val;
  const int pp1 = c1_rise ? i : d->pos;
  // case 2: inside a candidate peak; follow the maximum, emit it once the
  // signal has dropped past peak_height and moved past half the window
  const bool c2_higher = cur > d->val;
  const float pv2 = c2_higher ? cur : d->val;
  const int pp2 = c2_higher ? i : d->pos;
  const bool above = pv2 > thr;
  const bool valid2 = d->valid || ((pv2 - cur) > ph && above);
  const bool emit = valid2 && (i - pp2) > half;
  // selects, not branches: the lanes of a warp take different cases
  const bool peak = active && in_peak, flat = active && !in_peak;
  d->pos = peak ? (emit ? -1 : pp2) : (flat ? pp1 : d->pos);
  d->val = peak ? (emit ? cur : pv2) : (flat ? pv1 : d->val);
  d->valid = peak ? valid2 && !emit : d->valid;
  *mask = peak && above;
  *mask_pos = pp2;
  return peak && emit ? pp2 : -1;
}

// Position i of a read with n live positions: the short detector on cur1
// (active from i = 1), its mask on the long one, the long detector on cur2;
// *e0, *e1: their emissions.  Past n no state changes and both emit -1.
RH_PK_HD void rh_peaks_step(RhPeakRow* r, float cur1, float cur2, int i, int n,
                            const RhPeakParams& P, int* e0, int* e1) {
  const bool alive = i < n;
  bool mask;
  int mask_pos;
  *e0 = rh_peak_detector(&r->d0, cur1, i, alive && i > 0, P.t1, P.half1, P.ph,
                         &mask, &mask_pos);
  // revent.c:125-131: the short detector's peak resets the long detector
  r->masked_to1 = mask ? mask_pos + P.w1 : r->masked_to1;
  r->d1.pos = mask ? -1 : r->d1.pos;
  r->d1.val = mask ? FLT_MAX : r->d1.val;
  r->d1.valid = !mask && r->d1.valid;
  bool unused;
  int unused_pos;
  *e1 = rh_peak_detector(&r->d1, cur2, i, alive && r->masked_to1 < i, P.t2,
                         P.half2, P.ph, &unused, &unused_pos);
}
