// The event detector's dual peak detector on Hopper (sm_90a): 32 reads a
// block, a lane a read, the short detector on one warp and the long one on
// a second warp a tile of positions behind it.
//
// Replaces the lax.scan of rawhash_tpu/signal/events.py:145 _gen_peaks
// (scan :184), which the JAX package compiles into its events program; the
// port's plain version, signal/events.py::_gen_peaks_plain, dispatches ~100
// torch ops a position.  The steps are rh_peaks_short and rh_peaks_long in
// events_peaks.cuh.
//
// What bounds it: each read is a serial chain over its positions (each
// detector's state carries from one to the next), and a batch of 256 reads
// is 8 blocks on 132 SMs, so the kernel is latency-bound: its time is the
// longest read's positions times one step's chain of dependent
// instructions (profiling/bounds.py::peaks_bound: the short detector's
// carried value).  Its bytes (two f32 inputs read once, two i32 emissions
// a position written once) take ~10x less.
//
// What the design does about it:
//   - the short detector never reads the long one, so the two run on two
//     warps of the block, which issue from different SM sub-partitions:
//     each warp's chain a position is one detector's, about half of the
//     step that ran both in series.  The short warp writes, a read and a
//     position at a time, a handoff word (RH_PK_NO_MASK, or "reset the long
//     detector, masked up to p") into a double-buffered shared tile; the
//     long warp steps the same tile once the short one has filled it.  The
//     tiles change hands on named barriers of the block's 64 threads
//     (bar.arrive by the warp that fills or frees a tile, bar.sync by the
//     one that waits for it), so neither warp waits on the other except
//     when the short warp runs two tiles ahead;
//   - the step takes its tests on the case it picks (the new maximum or the
//     old one) rather than on the selected value, so the carried value is
//     one select a position (events_peaks.cuh); the liveness tests of a
//     position (i < n, i > 0) hang off a count taken once a tile;
//   - a thread keeps its read's state in registers and steps it from shared
//     memory, so no step waits on a global load: each warp moves its own
//     input in tiles of 32 positions x 32 reads a read at a time, 128
//     contiguous bytes a load, the next tile's loads in flight while the
//     current one is stepped, and its emissions leave the same way, every
//     other int of 256 contiguous bytes a read;
//   - a full tile's 32 steps are unrolled without branches (positions past
//     a read's n_sig are not live, so the last tile needs no other path);
//   - a warp steps only up to its longest read's n_sig and writes -1 past
//     it, with no host sync.
#include <cuda_runtime.h>

#include "events_peaks.cuh"

namespace {

constexpr int kRows = 32;  // reads a block, a lane each
constexpr int kTile = 32;  // positions a tile
constexpr int kThreads = 64;
// named barriers (0 is __syncthreads): a handoff tile filled, freed
constexpr int kFull = 1, kFree = 3;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// lane's position t0 + lane of each of the block's rows (0 past them)
__device__ __forceinline__ void load_tile(const float* __restrict__ ts,
                                          int row0, int rows, int l, int t0,
                                          int lane, float (&v)[kRows]) {
  const int t = t0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = (r < rows && t < l) ? __ldg(ts + (size_t)(row0 + r) * l + t) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    events_peaks_kernel(const float* __restrict__ ts1,
                        const float* __restrict__ ts2,
                        const int* __restrict__ n_sig, int* __restrict__ out,
                        int b, int l, RhPeakParams P) {
  __shared__ float s_in[2][kRows][kTile + 1];    // each warp's input tile
  __shared__ int sout[2][kRows][kTile + 1];     // each warp's emissions
  __shared__ int hand[2][kRows][kTile + 1];     // the handoff, two tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool is_long = warp == 1;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, b - row0);
  int n = lane < rows ? n_sig[row0 + lane] : 0;
  n = n < 0 ? 0 : (n > l ? l : n);
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  const int live_tiles = (n_max + kTile - 1) / kTile;
  const float* ts = is_long ? ts2 : ts1;
  float(&s)[kRows][kTile + 1] = s_in[warp];
  int(&so)[kRows][kTile + 1] = sout[warp];
  RhPeakDet d = rh_peak_fresh();
  int masked_to = 0;
  float v[kRows];
  if (live_tiles) load_tile(ts, row0, rows, l, 0, lane, v);
  for (int t = 0, t0 = 0; t0 < l; ++t, t0 += kTile) {
    const bool live = t < live_tiles;
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r][lane] = v[r];
      __syncwarp();
      if (t + 1 < live_tiles) load_tile(ts, row0, rows, l, t0 + kTile, lane, v);
      const int nrem = n - t0;  // lane's live positions from t0 on
      int(&h)[kRows][kTile + 1] = hand[t & 1];
      if (!is_long) {
        if (t >= 2) bar_sync(kFree + (t & 1));  // the long warp is done with it
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          int e0;
          h[lane][j] = rh_peaks_short(&d, s[lane][j], t0 + j,
                                      j < nrem && (j > 0 || t0 > 0), P, &e0);
          so[lane][j] = e0;
        }
        __threadfence_block();
        bar_arrive(kFull + (t & 1));
      } else {
        bar_sync(kFull + (t & 1));  // the short warp has filled it
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          so[lane][j] = rh_peaks_long(&d, &masked_to, s[lane][j], t0 + j,
                                      j < nrem, h[lane][j], P);
        if (t + 2 < live_tiles) bar_arrive(kFree + (t & 1));
      }
      __syncwarp();
    }
    // this warp's emission of each position: every other int of out
    if (t0 + lane < l)
      for (int r = 0; r < rows; ++r)
        out[(size_t)(row0 + r) * 2 * l + 2 * (size_t)(t0 + lane) + warp] =
            live ? so[r][lane] : -1;
    __syncwarp();
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Device
// pointers to C-contiguous arrays: ts1, ts2 f32 [b, l] (the short and the
// long window's t-statistics, finite), n_sig i32 [b] (clamped to [0, l]),
// out i32 [b, 2 l] (every entry written: position i's two emissions at 2i,
// 2i + 1).
extern "C" int rh_events_peaks(const float* ts1, const float* ts2,
                               const int* n_sig, int* out, int b, int l,
                               float t1, float t2, float ph, int w1, int half1,
                               int half2, void* stream) {
  if (b <= 0 || l <= 0) return 0;
  const RhPeakParams P = {t1, t2, ph, w1, half1, half2};
  events_peaks_kernel<<<(b + kRows - 1) / kRows, kThreads, 0,
                        (cudaStream_t)stream>>>(ts1, ts2, n_sig, out, b, l, P);
  return (int)cudaGetLastError();
}
