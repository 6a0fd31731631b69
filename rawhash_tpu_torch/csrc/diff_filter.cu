// The sketch's event-difference filter on Hopper (sm_90a): one thread a
// read, 32 reads a warp, a warp a block.
//
// Replaces the lax.scan of rawhash_tpu/sketch/device.py:22 _diff_filter
// (scan :35), which the JAX package compiles into its sketch program; the
// port's plain version, sketch/device.py::_diff_filter_plain, dispatches a
// few torch ops an event.  The step is rh_diff_keep in diff_filter.cuh.
//
// What bounds it: each read is a serial chain over its events (the last
// kept value carries), a subtract, a compare and a select an event, and a
// batch of 256 reads is 8 warps, so the kernel is latency-bound: the
// longest read's events times that chain (profiling/bounds.py::
// diff_filter_bound), unless the bytes (events read once, one byte an
// event written once) take longer.
//
// What the design does about it: as events_peaks.cu, the warp moves tiles
// of 32 events x 32 reads through shared memory a read at a time (128
// contiguous bytes a load, 32 a store), the next tile's loads issued into
// registers before the current tile is stepped; a warp steps only up to
// its longest read's n_ev and writes 0 past it, with no host sync.
#include <cuda_runtime.h>
#include <stdint.h>

#include "diff_filter.cuh"

namespace {

constexpr int kRows = 32;  // reads a block, a lane each
constexpr int kTile = 32;  // events a tile

__device__ __forceinline__ void load_tile(const float* __restrict__ ev,
                                          int row0, int rows, int e, int t0,
                                          int lane, float (&v)[kRows]) {
  const int t = t0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = (r < rows && t < e) ? __ldg(ev + (size_t)(row0 + r) * e + t) : 0.0f;
}

__global__ void __launch_bounds__(kRows)
    diff_filter_kernel(const float* __restrict__ events,
                       const int* __restrict__ n_ev, uint8_t* __restrict__ keep,
                       int b, int e, float diff) {
  __shared__ float sv[kRows][kTile + 1];
  __shared__ uint8_t sk[kRows][kTile + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, b - row0);
  int n = lane < rows ? n_ev[row0 + lane] : 0;
  n = n < 0 ? 0 : (n > e ? e : n);
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  float last = 0.0f;
  float v[kRows];
  if (n_max > 0) load_tile(events, row0, rows, e, 0, lane, v);
  for (int t0 = 0; t0 < e; t0 += kTile) {
    const int width = min(kTile, e - t0);
    const bool live = t0 < n_max;
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) sv[r][lane] = v[r];
      __syncwarp();
      if (t0 + kTile < n_max) load_tile(events, row0, rows, e, t0 + kTile, lane, v);
      for (int j = 0; j < width; ++j)
        sk[lane][j] = rh_diff_keep(sv[lane][j], t0 + j, n, diff, &last);
      __syncwarp();
    }
    if (lane < width)
      for (int r = 0; r < rows; ++r)
        keep[(size_t)(row0 + r) * e + t0 + lane] = live ? sk[r][lane] : 0;
    __syncwarp();
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Device
// pointers to C-contiguous arrays: events f32 [b, e], n_ev i32 [b] (clamped
// to [0, e]), keep u8 [b, e] (every entry written, 0 or 1: a torch.bool
// tensor's bytes).
extern "C" int rh_diff_filter(const float* events, const int* n_ev,
                              uint8_t* keep, int b, int e, float diff,
                              void* stream) {
  if (b <= 0 || e <= 0) return 0;
  diff_filter_kernel<<<(b + kRows - 1) / kRows, kRows, 0,
                       (cudaStream_t)stream>>>(events, n_ev, keep, b, e, diff);
  return (int)cudaGetLastError();
}
