// The slanted-band DTW on Hopper (sm_90a): ragged pairs, the long ones a
// warp each, the short ones a thread each, in one launch.
//
// Replaces the lax.scan of rawhash_tpu/dtw/device.py:33 dtw_banded_batch
// (scan :115), which the JAX package compiles into one program over the
// band's columns, its pairs padded to one length; the port's plain version,
// dtw/device.py::dtw_banded_batch_plain, dispatches ~60 torch ops a column.
// A pair's columns are rh_dtw_pair (a thread) and rh_dtw_pair_warp (a
// warp) in dtw_banded.cuh.
//
// What bounds it: a column's slots are w = 2 max_radius + 1 adds, mins and
// selects for each pair, with a running sum (XLA's order, for the same
// rounding) and a running minimum along the band, and each slot waits for
// the column before; a call holds tens of thousands of pairs of a few
// columns and a few of up to hundreds, so the call takes the longer of the
// card's issue rate over all pairs and the longest pair's chain
// (profiling/bounds.py::dtw_bound).
//
// What the design does about it:
//   - ragged rows: pair p's a and b at a[a_off[p]] and b[b_off[p]], their
//     own lengths, no padding to the longest (the padded entry passes row
//     offsets p L and cap = L);
//   - the pairs taken in `order` (longest first): the first long_warps
//     blocks each take the pair at their position on a warp
//     (rh_dtw_pair_warp, a wavefront over its columns: a column costs the
//     warp about L steps, where a thread takes w slots in a row) if it has
//     at least `threshold` columns, so the long pairs start first; the
//     blocks after them take 32 positions each, a thread a pair
//     (rh_dtw_pair), skipping those a warp took, so a warp's 32 pairs have
//     similar lengths;
//   - each cost written to its pair's own place (out[order[k]]);
//   - a block of one warp, so the pairs spread over every SM and a warp
//     waits only for its own pairs; the thread path's bands at row
//     positions in shared memory, lane-interleaved ([slot][lane], 32 banks);
//     the warp path's rows of b staged in the same memory a round ahead.
// Bands past kSharedWidth slots (2 x 4 B x 32 pairs a slot, three slots
// more, over a block's 227 KB) keep the thread path's layout in a global
// scratch, [slot][position]; bands of 32 x RH_DTW_MAX_LAG slots or more
// take the thread path only.
#include <cuda_runtime.h>

#include <atomic>

#include "dtw_banded.cuh"

namespace {

constexpr int kPairs = 32;  // pairs a thread-path block, a lane each
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int kSharedWidth = kSmemMax / (2 * 4 * kPairs) - RH_DTW_PAD;

struct Args {
  const float* a;
  const int* a_off;
  const int* a_len;
  const float* b;
  const int* b_off;
  const int* b_len;
  const int* radius;
  const int* order;  // the pair at each position (longest first)
  float* out;
  int pairs, r, cap, threshold, long_warps;
  float* scratch;  // the thread path's bands past kSharedWidth, else null
};

// L > 0: the first x.long_warps blocks are the warp path's, at lag L; L = 0:
// none.  kShared: the thread path's bands in shared memory (else in
// x.scratch).
template <int N, int L, bool kShared>
__global__ void __launch_bounds__(kPairs) dtw_banded_kernel(const Args x) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int w = 2 * x.r + 1;
  if constexpr (L > 0) {
    if ((int)blockIdx.x < x.long_warps) {
      const int k = blockIdx.x;
      const int p = x.order[k];
      const int a_len = x.a_len[p];
      if (!rh_dtw_takes_warp(k, a_len < x.cap ? a_len : x.cap, x.long_warps,
                             x.threshold))
        return;  // a thread-path lane takes it
      const float v = rh_dtw_pair_warp<RhDtwDevWarp, N, L>(
          RhDtwDevWarp(), x.a + x.a_off[p], a_len, x.b + x.b_off[p], x.b_len[p],
          x.cap, x.radius[p], x.r, smem);
      if (lane == 0) x.out[p] = v;
      return;
    }
  }
  const int k = ((int)blockIdx.x - (L > 0 ? x.long_warps : 0)) * kPairs + lane;
  if (k >= x.pairs) return;
  const int p = x.order[k];
  const int a_len = x.a_len[p];
  if (L > 0 && rh_dtw_takes_warp(k, a_len < x.cap ? a_len : x.cap, x.long_warps,
                                 x.threshold))
    return;  // a warp took it
  const int slots = w + RH_DTW_PAD;
  const RhDtwBand band =
      kShared ? RhDtwBand{smem + lane, smem + (size_t)kPairs * slots + lane, kPairs}
              : RhDtwBand{x.scratch + k, x.scratch + (size_t)x.pairs * slots + k, x.pairs};
  x.out[p] = rh_dtw_pair<N>(x.a + x.a_off[p], a_len, x.b + x.b_off[p], x.b_len[p],
                            x.cap, x.radius[p], x.r, band);
}

// the dynamic shared memory each instance is allowed so far on each device
// (the attribute is a host call a launch would otherwise repeat, and it
// holds only for the device that was current when it was set)
constexpr int kMaxDevices = 64;
template <int N, int L, bool kShared>
std::atomic<int> g_smem_set[kMaxDevices];

template <int N, int L, bool kShared>
int launch(Args x, cudaStream_t stream) {
  const long long w = 2LL * x.r + 1;
  if (L == 0 || x.long_warps < 0) x.long_warps = 0;
  if (x.long_warps > x.pairs) x.long_warps = x.pairs;
  const dim3 grid(x.long_warps + (x.pairs + kPairs - 1) / kPairs);
  long long smem = L > 0 && x.long_warps > 0 ? 4LL * rh_dtw_warp_floats((int)w, L) : 0;
  if (!kShared) {
    if (x.scratch == nullptr) return (int)cudaErrorInvalidValue;
  } else {
    x.scratch = nullptr;
    const long long thread = 2LL * 4 * kPairs * (w + RH_DTW_PAD);
    smem = smem > thread ? smem : thread;
  }
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::atomic<int>& set = g_smem_set<N, L, kShared>[dev];
    if (smem > set.load()) {
      e = cudaFuncSetAttribute((const void*)dtw_banded_kernel<N, L, kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      int seen = set.load();
      while (seen < smem && !set.compare_exchange_weak(seen, (int)smem)) {
      }
    }
  }
  dtw_banded_kernel<N, L, kShared><<<grid, kPairs, (size_t)smem, stream>>>(x);
  return (int)cudaGetLastError();
}

template <int N>
int launch_lag(const Args& x, int lag, cudaStream_t s) {
  switch (lag) {
#define RH_DTW_L(L) \
  case L:           \
    return launch<N, L, true>(x, s);
    RH_DTW_L(2) RH_DTW_L(3) RH_DTW_L(4) RH_DTW_L(5)
    RH_DTW_L(6) RH_DTW_L(7) RH_DTW_L(8)
#undef RH_DTW_L
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The band width past which a launch needs a scratch of 2 x (width + 3) x
// pairs floats (up to it, the bands are in shared memory).
extern "C" int rh_dtw_shared_width(void) { return kSharedWidth; }

// Launch on `stream`; returns a CUDA error code (0 on success).  Device
// pointers: a, b f32 (pair p's values at a[a_off[p]], b[b_off[p]]); a_off,
// a_len, b_off, b_len, radius i32 [pairs]; order i32 [pairs] (a
// permutation of the pairs, longest first for speed); out
// f32 [pairs].  r = max_radius >= 0; cap: the most values of a pair's row
// read (padded rows: their length); the first long_warps positions of the
// order with at least `threshold` columns run a warp each, at the band's
// lag (rh_dtw_default_lag: the least with 2 r + 1 < 32 lag; bands of
// 32 x RH_DTW_MAX_LAG - 1 slots or more take the thread path only);
// scratch: 2 (2 r + 4) pairs floats when 2 r + 1 > rh_dtw_shared_width(),
// else unused (may be null).
extern "C" int rh_dtw_banded(const float* a, const int* a_off, const int* a_len,
                             const float* b, const int* b_off, const int* b_len,
                             const int* radius, const int* order, float* out,
                             int pairs, int r, int cap, int threshold,
                             int long_warps, float* scratch, void* stream) {
  if (pairs <= 0) return 0;
  if (r < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long w = 2LL * r + 1;
  const Args x = {a, a_off, a_len, b, b_off, b_len, radius, order, out,
                  pairs, r, cap, threshold, long_warps, scratch};
  const int lag = w >= 32 * RH_DTW_MAX_LAG ? 0 : rh_dtw_default_lag((int)w);
  switch (rh_dtw_levels(w)) {
    case 1:
      return launch_lag<1>(x, lag, s);
    case 2:
      return launch_lag<2>(x, lag, s);
#define RH_DTW_CASE(N)                                   \
  case N:                                                \
    return w > kSharedWidth ? launch<N, 0, false>(x, s)  \
                            : launch<N, 0, true>(x, s);
    RH_DTW_CASE(3) RH_DTW_CASE(4) RH_DTW_CASE(5)
    RH_DTW_CASE(6) RH_DTW_CASE(7) RH_DTW_CASE(8)
#undef RH_DTW_CASE
  }
  return (int)cudaErrorInvalidValue;
}
