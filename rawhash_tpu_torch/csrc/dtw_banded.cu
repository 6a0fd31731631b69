// The slanted-band DTW on Hopper (sm_90a): a thread a pair, 32 pairs a
// block of one warp, each pair's band in shared memory (or, for a band
// wider than shared memory holds, in a global scratch).
//
// Replaces the lax.scan of rawhash_tpu/dtw/device.py:33 dtw_banded_batch
// (scan :115), which the JAX package compiles into one program over the
// band's columns; the port's plain version, dtw/device.py::
// dtw_banded_batch_plain, dispatches ~60 torch ops a column.  The pair's
// columns are rh_dtw_pair in dtw_banded.cuh.
//
// What bounds it: a column's slots are w = 2 max_radius + 1 adds, mins and
// selects for each pair, with a running sum (XLA's order, for the same
// rounding) and a running minimum along the band and each column waiting
// for the last, so a pair is a serial chain of columns x slots; a batch
// holds tens of thousands of pairs, so the card's issue rate over all of
// them bounds it (profiling/bounds.py::dtw_bound: the fp32 adds and mins a
// slot a column, the bytes of a and b, the longest pair's chain).
//
// What the design does about it:
//   - a thread a pair: every add, min and select of a slot is one
//     instruction for 32 pairs, with no shuffle, and the ordered sum is the
//     plain running sum it has to be (a warp a pair would spend shuffles on
//     each slot's sum and minimum);
//   - the band's slots in shared memory, lane-interleaved ([slot][lane]),
//     so a warp's 32 accesses fall on 32 banks: a slot is two loads (dp
//     and b's value three slots ahead) and two stores, in place
//     (dtw_banded.cuh), the level-0 sums a block of 16 slots unrolled;
//   - a and the row a slide brings in are read a column ahead;
//   - a block of one warp, so a batch spreads over every SM (36401 pairs
//     are 1138 blocks) and a warp waits only for its own 32 pairs' longest.
// Bands past kSharedWidth slots (2 x 4 B x 32 pairs a slot, three slots
// more, over a block's 227 KB) keep the same layout in a global scratch,
// [slot][pair].
#include <cuda_runtime.h>

#include <atomic>

#include "dtw_banded.cuh"

namespace {

constexpr int kPairs = 32;  // pairs a block, a lane each
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int kSharedWidth = kSmemMax / (2 * 4 * kPairs) - RH_DTW_PAD;

template <int N, bool kShared>
__global__ void __launch_bounds__(kPairs)
    dtw_banded_kernel(const float* __restrict__ a, const int* __restrict__ a_len,
                      const float* __restrict__ b, const int* __restrict__ b_len,
                      const int* __restrict__ radius, float* __restrict__ out,
                      int pairs, int max_len, int r, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int p = blockIdx.x * kPairs + lane;
  if (p >= pairs) return;
  const int slots = 2 * r + 1 + RH_DTW_PAD;
  const RhDtwBand band =
      kShared ? RhDtwBand{smem + lane, smem + (size_t)kPairs * slots + lane, kPairs}
              : RhDtwBand{scratch + p, scratch + (size_t)pairs * slots + p, pairs};
  out[p] = rh_dtw_pair<N>(a + (size_t)p * max_len, b + (size_t)p * max_len,
                          max_len, a_len[p], b_len[p], radius[p], r, band);
}

// the dynamic shared memory each instance is allowed so far on each device
// (the attribute is a host call a launch would otherwise repeat, and it
// holds only for the device that was current when it was set)
constexpr int kMaxDevices = 64;
constexpr int kLevels = 8;  // rh_dtw_levels of any int width
std::atomic<int> g_smem_set[kMaxDevices][kLevels + 1];

template <int N>
int launch(const float* a, const int* a_len, const float* b, const int* b_len,
           const int* radius, float* out, int pairs, int max_len, int r,
           float* scratch, cudaStream_t stream) {
  const long long w = 2LL * r + 1;
  const dim3 grid((pairs + kPairs - 1) / kPairs);
  if (w > kSharedWidth) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    dtw_banded_kernel<N, false><<<grid, kPairs, 0, stream>>>(
        a, a_len, b, b_len, radius, out, pairs, max_len, r, scratch);
    return (int)cudaGetLastError();
  }
  const int smem = (int)(2 * 4 * kPairs * (w + RH_DTW_PAD));
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::atomic<int>& set = g_smem_set[dev][N];
    if (smem > set.load()) {
      e = cudaFuncSetAttribute((const void*)dtw_banded_kernel<N, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      int seen = set.load();
      while (seen < smem && !set.compare_exchange_weak(seen, smem)) {
      }
    }
  }
  dtw_banded_kernel<N, true><<<grid, kPairs, smem, stream>>>(
      a, a_len, b, b_len, radius, out, pairs, max_len, r, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// The band width past which a launch needs a scratch of 2 x (width + 3) x
// pairs floats (up to it, the band is in shared memory).
extern "C" int rh_dtw_shared_width(void) { return kSharedWidth; }

// Launch on `stream`; returns a CUDA error code (0 on success).  Device
// pointers to C-contiguous arrays: a, b f32 [pairs, max_len] (max_len >= 1),
// a_len, b_len, radius i32 [pairs], out f32 [pairs]; r = max_radius >= 0;
// scratch: 2 (2 r + 4) pairs floats when 2 r + 1 > rh_dtw_shared_width(),
// else unused (may be null).
extern "C" int rh_dtw_banded(const float* a, const int* a_len, const float* b,
                             const int* b_len, const int* radius, float* out,
                             int pairs, int max_len, int r, float* scratch,
                             void* stream) {
  if (pairs <= 0) return 0;
  if (max_len < 1 || r < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rh_dtw_levels(2LL * r + 1)) {
#define RH_DTW_CASE(N) \
  case N:              \
    return launch<N>(a, a_len, b, b_len, radius, out, pairs, max_len, r, scratch, s);
    RH_DTW_CASE(1) RH_DTW_CASE(2) RH_DTW_CASE(3) RH_DTW_CASE(4)
    RH_DTW_CASE(5) RH_DTW_CASE(6) RH_DTW_CASE(7) RH_DTW_CASE(8)
#undef RH_DTW_CASE
  }
  return (int)cudaErrorInvalidValue;
}
