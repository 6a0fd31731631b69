// The sketch's event-difference filter on Hopper (sm_90a): a lane a read,
// 32 reads a stepping block of one warp, and fill blocks beside them in
// the same launch.
//
// Replaces the lax.scan of rawhash_tpu/sketch/device.py:22 _diff_filter
// (scan :35), which the JAX package compiles into its sketch program; the
// port's plain version, sketch/device.py::_diff_filter_plain, dispatches a
// few torch ops an event.  The tile step is rh_diff_tile in diff_filter.cuh.
//
// What bounds it: each read is a serial chain over its events (the last
// kept value carries), a subtract, a compare and a select an event, and a
// batch of 256 reads is 8 warps, so the kernel is latency-bound: the
// longest read's events times that chain (profiling/bounds.py::
// diff_filter_bound), unless the bytes (events read once, one byte an
// event written once) take longer.
//
// What the design does about it (a first design moved each tile
// through shared memory, stepped it with a shared-memory load and a byte
// store an event, tested liveness on every event, and zero-filled every
// tile past the live ones on the stepping warp):
//   - a lane holds its read's tile of 32 events in registers, loaded as
//     eight 16-byte loads of its own row, the next four tiles' loads in
//     flight while the current tile is stepped; the 32 steps are unrolled
//     and the chain an event is FADD -> FSETP (|.| an operand modifier) ->
//     FSEL on `last`, the keep bit selected off the chain;
//   - no liveness test an event: a tile's mask is cut at the read's n
//     once, and event 0 is taken before the first tile (diff_filter.cuh);
//   - the mask leaves as 32 bytes of 0/1 in two 16-byte stores a lane;
//   - the stepping warp stops at the tile holding its longest read's last
//     event; every byte past it is zeroed by fill blocks of the same launch
//     (blockIdx.y > 0: a block a group and 512 columns, 16-byte stores a
//     lane across a row), which run on other SMs while the chains step, so
//     one launch still writes every byte with no host sync.
// A row length that is not a multiple of 16 (or an unaligned base) takes
// the same steps with scalar loads and byte stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "diff_filter.cuh"

namespace {

constexpr int kRows = 32;      // reads a group, a lane each
constexpr int kTile = RH_DF_TILE;
constexpr int kFillCols = 512;  // columns a fill block zeroes
// tiles in flight ahead of the step: a tile's loads are eight 16-byte
// loads a lane, each over 32 rows, and a ring of one tile left the step
// waiting on them; 4 keeps 160 floats a lane in registers (one warp a
// block, so registers are not what bounds the blocks an SM)
constexpr int kAhead = 4;

// The stamp build (-DRH_DF_STAMPS, profiling/kernel_time.py::
// filter_stamps) writes, for each group's stepping warp,
// RH_DF_STAMPS_WORDS words: the SM clock at entry, when the tile loop
// starts and when it ends, and the live end (events stepped a read).
// Other builds stamp nothing.
#define RH_DF_STAMPS_WORDS 4
#ifdef RH_DF_STAMPS
__device__ long long* g_df_stamps;
#define RH_DF_STAMP(slot, v)                                                 \
  do {                                                                       \
    if (g_df_stamps && lane == 0)                                            \
      g_df_stamps[(long long)blockIdx.x * RH_DF_STAMPS_WORDS + (slot)] = (v); \
  } while (0)
#else
#define RH_DF_STAMP(slot, v) \
  do {                       \
  } while (0)
#endif

// lane's tile of 32 events from t0 (0 past e)
template <bool kWide>
__device__ __forceinline__ void load_tile(const float* __restrict__ ev, int e,
                                          int t0, float (&v)[kTile]) {
  if (kWide) {
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      const float4 x = t0 + 4 * q < e
                           ? __ldg(reinterpret_cast<const float4*>(ev + t0) + q)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) v[j] = t0 + j < e ? __ldg(ev + t0 + j) : 0.0f;
  }
}

// one tile stepped, cut at the read's n and written from t0
template <bool kWide>
__device__ __forceinline__ void step_tile(const float (&v)[kTile], float* last,
                                          float diff, int n, int t0, int e,
                                          uint8_t* __restrict__ kp) {
  const uint32_t m = (rh_diff_tile(v, last, diff) | (t0 == 0 ? 1u : 0u)) &
                     rh_diff_live(n - t0);
  uint32_t w[kTile / 4];
  rh_diff_bytes(m, w);
  if (kWide) {
    uint4* dst = reinterpret_cast<uint4*>(kp + t0);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    if (t0 + 16 < e) dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      if (t0 + j < e) kp[t0 + j] = (uint8_t)((w[j / 4] >> (8 * (j % 4))) & 1u);
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kRows)
    diff_filter_kernel(const float* __restrict__ events,
                       const int* __restrict__ n_ev, uint8_t* __restrict__ keep,
                       int b, int e, float diff) {
  const int lane = threadIdx.x;
#ifdef RH_DF_STAMPS
  const long long entry = clock64();
#endif
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, b - row0);
  int n = lane < rows ? n_ev[row0 + lane] : 0;
  n = n < 0 ? 0 : (n > e ? e : n);
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  // the stepping warp writes [0, live_end) of each row, the fill blocks the rest
  const int live_end = min(e, (n_max + kTile - 1) / kTile * kTile);
  if (blockIdx.y > 0) {
    const int c0 = max(live_end, ((int)blockIdx.y - 1) * kFillCols);
    const int c1 = min(e, (int)blockIdx.y * kFillCols);
    if (c0 >= c1) return;
    for (int r = 0; r < rows; ++r) {
      uint8_t* kp = keep + (size_t)(row0 + r) * e;
      if (kWide) {
        // c0 and c1 are multiples of 16: c1 - c0 <= 512 is 32 stores or fewer
        if (c0 + 16 * lane < c1)
          *reinterpret_cast<uint4*>(kp + c0 + 16 * lane) = make_uint4(0, 0, 0, 0);
      } else {
        for (int c = c0 + lane; c < c1; c += kRows) kp[c] = 0;
      }
    }
    return;
  }
  if (lane >= rows || live_end == 0) return;
  const float* ev = events + (size_t)(row0 + lane) * e;
  uint8_t* kp = keep + (size_t)(row0 + lane) * e;
  // a ring of kAhead + 1 tiles in registers: tile t is stepped while tiles
  // t + 1 .. t + kAhead are in flight; a trip steps the whole ring, so
  // every index into it is a constant
  constexpr int kBuf = kAhead + 1;
  float v[kBuf][kTile];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u * kTile < live_end) load_tile<kWide>(ev, e, u * kTile, v[u]);
  float last = v[0][0];
  RH_DF_STAMP(0, entry);
  RH_DF_STAMP(1, clock64());
  for (int t0 = 0; t0 < live_end; t0 += kBuf * kTile) {
#pragma unroll
    for (int u = 0; u < kBuf; ++u) {
      const int t = t0 + u * kTile;
      if (t >= live_end) break;
      if (t + kAhead * kTile < live_end)
        load_tile<kWide>(ev, e, t + kAhead * kTile, v[(u + kAhead) % kBuf]);
      step_tile<kWide>(v[u], &last, diff, n, t, e, kp);
    }
  }
  RH_DF_STAMP(2, clock64());
  RH_DF_STAMP(3, live_end);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Device
// pointers to C-contiguous arrays: events f32 [b, e], n_ev i32 [b] (clamped
// to [0, e]), keep u8 [b, e] (every entry written, 0 or 1: a torch.bool
// tensor's bytes).  One launch: a stepping block for each group of 32
// reads, and beside it a fill block for each 512 columns of the group.
extern "C" int rh_diff_filter(const float* events, const int* n_ev,
                              uint8_t* keep, int b, int e, float diff,
                              void* stream) {
  if (b <= 0 || e <= 0) return 0;
  const dim3 grid((b + kRows - 1) / kRows, 1 + (e + kFillCols - 1) / kFillCols);
  const bool wide = e % 16 == 0 && (uintptr_t)events % 16 == 0 &&
                    (uintptr_t)keep % 16 == 0;
  if (wide)
    diff_filter_kernel<true><<<grid, kRows, 0, (cudaStream_t)stream>>>(
        events, n_ev, keep, b, e, diff);
  else
    diff_filter_kernel<false><<<grid, kRows, 0, (cudaStream_t)stream>>>(
        events, n_ev, keep, b, e, diff);
  return (int)cudaGetLastError();
}

#ifdef RH_DF_STAMPS
// The stamp build's buffer (RH_DF_STAMPS_WORDS words a group), or null to
// stamp nothing; returns a CUDA error code.
extern "C" int rh_diff_set_stamps(long long* p) {
  return (int)cudaMemcpyToSymbol(g_df_stamps, &p, sizeof p);
}
#endif
