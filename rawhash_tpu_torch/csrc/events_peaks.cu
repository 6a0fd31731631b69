// The event detector's dual peak detector on Hopper (sm_90a): one thread a
// read, 32 reads a warp, a warp a block.
//
// Replaces the lax.scan of rawhash_tpu/signal/events.py:145 _gen_peaks
// (scan :184), which the JAX package compiles into its events program; the
// port's plain version, signal/events.py::_gen_peaks_plain, dispatches ~100
// torch ops a position.  The step is rh_peaks_step in events_peaks.cuh.
//
// What bounds it: each read is a serial chain over its positions (the
// detectors' state carries from one to the next), and a batch of 256 reads
// is 8 warps on 132 SMs, so the kernel is latency-bound: its time is the
// longest read's positions times one step's chain of dependent
// instructions (profiling/bounds.py::peaks_bound).  Its bytes (two f32
// inputs read once, two i32 emissions a position written once) take ~10x
// less.
//
// What the design does about it:
//   - a thread keeps its read's state in registers and steps it from shared
//     memory, so no step waits on a global load;
//   - the warp moves tiles of 32 positions x 32 reads between global and
//     shared memory a read at a time, 128 contiguous bytes a load, so every
//     access is coalesced (a thread walking its own row would touch a
//     sector a thread a step); the next tile's loads are issued into
//     registers before the current tile is stepped, so their latency hides
//     behind its 32 steps;
//   - the emissions leave the same way, through a shared tile, 256 bytes a
//     read;
//   - a full tile's 32 steps are unrolled and the step has no branch (the
//     lanes of a warp sit in different cases of the detector), so the
//     warp issues one stream of selects;
//   - a warp steps only up to its longest read's n_sig and writes -1 past
//     it, with no host sync (the plain loop stops at the batch's longest
//     read, which it reads back to the host).
#include <cuda_runtime.h>

#include "events_peaks.cuh"

namespace {

constexpr int kRows = 32;  // reads a block, a lane each
constexpr int kTile = 32;  // positions a tile

// lane's position t0 + lane of each of the block's rows (0 past them)
__device__ __forceinline__ void load_tile(const float* __restrict__ ts,
                                          int row0, int rows, int l, int t0,
                                          int lane, float (&v)[kRows]) {
  const int t = t0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = (r < rows && t < l) ? __ldg(ts + (size_t)(row0 + r) * l + t) : 0.0f;
}

// position t0 + j of lane's read, from the shared tiles into the shared
// emissions
__device__ __forceinline__ void step(RhPeakRow* st,
                                     const float (&s1)[kRows][kTile + 1],
                                     const float (&s2)[kRows][kTile + 1],
                                     int (&so)[kRows][2 * kTile + 1], int lane,
                                     int j, int t0, int n,
                                     const RhPeakParams& P) {
  int e0, e1;
  rh_peaks_step(st, s1[lane][j], s2[lane][j], t0 + j, n, P, &e0, &e1);
  so[lane][2 * j] = e0;
  so[lane][2 * j + 1] = e1;
}

__global__ void __launch_bounds__(kRows)
    events_peaks_kernel(const float* __restrict__ ts1,
                        const float* __restrict__ ts2,
                        const int* __restrict__ n_sig, int* __restrict__ out,
                        int b, int l, RhPeakParams P) {
  __shared__ float s1[kRows][kTile + 1];
  __shared__ float s2[kRows][kTile + 1];
  __shared__ int so[kRows][2 * kTile + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, b - row0);
  int n = lane < rows ? n_sig[row0 + lane] : 0;
  n = n < 0 ? 0 : (n > l ? l : n);
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  RhPeakRow st = rh_peak_row();
  float v1[kRows], v2[kRows];
  if (n_max > 0) {
    load_tile(ts1, row0, rows, l, 0, lane, v1);
    load_tile(ts2, row0, rows, l, 0, lane, v2);
  }
  for (int t0 = 0; t0 < l; t0 += kTile) {
    const int width = min(kTile, l - t0);
    const bool live = t0 < n_max;
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s1[r][lane] = v1[r];
        s2[r][lane] = v2[r];
      }
      __syncwarp();
      if (t0 + kTile < n_max) {
        load_tile(ts1, row0, rows, l, t0 + kTile, lane, v1);
        load_tile(ts2, row0, rows, l, t0 + kTile, lane, v2);
      }
      if (width == kTile) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) step(&st, s1, s2, so, lane, j, t0, n, P);
      } else {
        for (int j = 0; j < width; ++j) step(&st, s1, s2, so, lane, j, t0, n, P);
      }
      __syncwarp();
    }
    for (int r = 0; r < rows; ++r) {
      int* o = out + (size_t)(row0 + r) * 2 * l + 2 * (size_t)t0;
      for (int c = lane; c < 2 * width; c += 32) o[c] = live ? so[r][c] : -1;
    }
    __syncwarp();
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Device
// pointers to C-contiguous arrays: ts1, ts2 f32 [b, l] (the short and the
// long window's t-statistics), n_sig i32 [b] (clamped to [0, l]), out i32
// [b, 2 l] (every entry written: position i's two emissions at 2i, 2i + 1).
extern "C" int rh_events_peaks(const float* ts1, const float* ts2,
                               const int* n_sig, int* out, int b, int l,
                               float t1, float t2, float ph, int w1, int half1,
                               int half2, void* stream) {
  if (b <= 0 || l <= 0) return 0;
  const RhPeakParams P = {t1, t2, ph, w1, half1, half2};
  events_peaks_kernel<<<(b + kRows - 1) / kRows, kRows, 0,
                        (cudaStream_t)stream>>>(ts1, ts2, n_sig, out, b, l, P);
  return (int)cudaGetLastError();
}
