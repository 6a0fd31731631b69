// f32 row prefix sums and row sums in XLA's CPU order on Hopper (sm_90a),
// of a row and, in the same pass, of its squares: G warps a row (a warp a
// row, four rows a block, for rows up to 8192 values; a block of 8 warps a
// row past that), level 0 in rounds of shared-memory tiles.
//
// Replaces jnp.sum and jnp.cumsum inside the jitted events program of the
// JAX package (rawhash_tpu/signal/events.py:287 detect_events_batch: the
// sums of the signal and its square at :307-308, the prefix sums of the
// clipped signal and its square at :319 and :322, and :261 in
// _segment_events), which XLA's CPU backend adds in the order of
// ordered_scan.cuh; the port's plain versions, signal/events.py::
// ordered_cumsum_plain and ordered_sum_plain, dispatch a torch op an add.
//
// What bounds it: the bytes, each row read once and its sums written once
// (profiling/bounds.py::scan_bound); the adds are as many as the values.
// At the events stage's 256 rows of 4000 values a call moves 4-12 MB, a
// few microseconds, so the launch and the latency of one row's chain of
// rounds count as much.
//
// What the design does about it:
//   - a warp copies its rounds into shared memory with cp.async, no
//     register held for them, the next rounds' copies in flight while it
//     adds one (a ring of tiles, a copy group a round): 4 bytes a lane, 32
//     consecutive floats an instruction, for any row stride and alignment,
//     or, for a sum whose row starts on 16 bytes, 16 bytes a lane; zeros
//     past the row; a lane then adds its block or window from the tile,
//     whose rows sit in distinct banks;
//   - a value and its square go through one pass (the events stage's pairs
//     sig_m, sig_m^2 and normc, normc^2), and the prefix sum writes its
//     leading zero itself, into rows of any stride;
//   - the prefix sum keeps a warp's tiles in shared memory from the
//     up-sweep to the down-sweep when they fit (at 4000 values they do),
//     so the row is read once; past that its rounds are copied again;
//   - the results leave through the tile too, 128 contiguous bytes a store;
//   - the levels above the row (1/15 of it, 1/31 for the sum) stay in
//     shared memory, a float of padding after each block (window) so that
//     the lanes, a block or window each, read from distinct banks
//     (rh_lev_at: unpadded, 32 lanes read one bank and a row's levels
//     took a fifth of the sum's time at 28672 values); the row's first
//     warp works them, and its second the squares' when a row has more
//     than one warp, waiting on __syncwarp(); the only block barriers are
//     the two around them when a row has more than one warp; the level
//     sizes come with the launch's plan (kernel parameters), not from
//     local memory.
#include <cuda_runtime.h>

#include <atomic>

#include "ordered_scan.cuh"

namespace {

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (< 8) of this thread's newest copy groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// The stamp build (-DRH_SCAN_STAMPS, profiling/kernel_time.py::scan_stamps)
// writes, for each warp, RH_STAMPS words: the global timer (ns) at entry,
// the SM clock at entry and at each phase (slots 2-6), the global timer at
// exit (slot RH_STAMP_EXIT), the SM's id; 0 where a warp does not reach a
// phase.  Other builds stamp nothing.
#define RH_STAMPS 9
#define RH_STAMP_EXIT 7
#ifdef RH_SCAN_STAMPS
__device__ long long* g_stamps;

__device__ __forceinline__ void stamp(int slot) {
  if ((threadIdx.x & 31) || !g_stamps) return;
  long long* p = g_stamps +
                 ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
                     RH_STAMPS;
  long long v;
  if (slot == 0 || slot == RH_STAMP_EXIT)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  else
    v = clock64();
  p[slot] = v;
  if (slot == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    p[RH_STAMPS - 1] = sm;
  }
}
#define RH_STAMP(slot) stamp(slot)
#else
#define RH_STAMP(slot) \
  do {                 \
  } while (0)
#endif

// the row's warps, or the warp alone
__device__ __forceinline__ void group_sync(int g) {
  if (g > 1)
    __syncthreads();
  else
    __syncwarp();
}

// 16 bytes (of which `bytes` from src, zeros after them)
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// warp w's round t (of g warps a row) into tile: the prefix sum's (512
// values) or the sum's (1024, after `front` zeros); not committed.  A sum
// whose round starts on 16 bytes (vec) copies 16 bytes a lane.
template <bool PREFIX>
__device__ __forceinline__ void stage(const float* __restrict__ xr, int n,
                                      int front, bool vec, float* tile, int t,
                                      int w, int g, int lane) {
  constexpr int kValues = PREFIX ? RH_CT_VALUES : RH_ST_VALUES;
  const int base = kValues * (t * g + w) - front;
  if (!PREFIX && vec) {
#pragma unroll
    for (int q = 0; q < kValues / 128; ++q) {
      const int i = base + 128 * q + 4 * lane;  // a multiple of 4
      const int bytes = i < 0 ? 0 : 4 * max(0, min(4, n - i));
      cp16(tile + rh_st_slot4(q, lane), bytes ? xr + i : xr, bytes);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kValues / 32; ++q) {
    const int i = base + 32 * q + lane;
    const bool ok = i >= 0 && i < n;
    cp4(tile + (PREFIX ? rh_ct_slot(q, lane) : rh_st_slot(q, lane)),
        ok ? xr + i : xr, ok);
  }
}

// A warp's rounds 0 .. mine - 1 through a ring of `ring` tiles, copies in
// flight for the next ring - 1 rounds while one is worked: work(t, tile)
// once round t has landed (a copy group a round).  With mine <= ring every
// round keeps its own tile (round t in tile t) after the pass.
template <bool PREFIX, class Work>
__device__ __forceinline__ void rounds(const float* __restrict__ xr, int n,
                                       int front, bool vec, float* tiles,
                                       int mine, int ring, int w, int g,
                                       int lane, Work work) {
  constexpr int kTile = PREFIX ? RH_CT_FLOATS : RH_ST_FLOATS;
  const int ahead = min(ring - 1, mine);
  for (int t = 0; t < ahead; ++t) {
    stage<PREFIX>(xr, n, front, vec, tiles + t * kTile, t, w, g, lane);
    cp_commit();
  }
  for (int t = 0; t < mine; ++t) {
    const int next = t + ring - 1;
    if (next < mine)
      stage<PREFIX>(xr, n, front, vec, tiles + (next % ring) * kTile, next, w,
                    g, lane);
    cp_commit();  // a group an iteration, empty or not
    cp_wait(ring - 1);  // round t's group has landed
    __syncwarp();
    work(t, tiles + (t % ring) * kTile);
    __syncwarp();  // the tile is free for round t + ring
  }
}

// The prefix sum's levels above the row on one warp, of L and (unless null)
// L2, each level 1 holding the totals of the row's blocks: the up-sweep,
// the top's scan, the down-sweep; level 1 then holds each block's prefix.
__device__ __forceinline__ void prefix_levels(float* L, float* L2,
                                              const RhScanPlan& P, int lane) {
  const int top = P.top;
  for (int j = 1; j < top; ++j) {
    for (int k = lane; k < P.sizes[j + 1]; k += 32) {
      const int at = P.offs[j + 1] + rh_lev_at(k, RH_SCAN_BLOCK, 0);
      L[at] = rh_cumsum_block_total(L + P.offs[j] + k, P.sizes[j], k);
      if (L2) L2[at] = rh_cumsum_block_total(L2 + P.offs[j] + k, P.sizes[j], k);
    }
    __syncwarp();
  }
  if (lane == 0) rh_cumsum_top(L + P.offs[top], P.sizes[top], L + P.offs[top]);
  if (L2 && lane == 1)
    rh_cumsum_top(L2 + P.offs[top], P.sizes[top], L2 + P.offs[top]);
  __syncwarp();
  for (int j = top - 1; j >= 1; --j) {
    for (int k = lane; k < P.sizes[j + 1]; k += 32) {
      const int pre = P.offs[j + 1] + rh_lev_at(k - 1, RH_SCAN_BLOCK, 0);
      float* blk = L + P.offs[j] + k;
      rh_cumsum_block_out(blk, P.sizes[j], k, k ? L[pre] : 0.0f, blk);
      if (L2) {
        float* blk2 = L2 + P.offs[j] + k;
        rh_cumsum_block_out(blk2, P.sizes[j], k, k ? L2[pre] : 0.0f, blk2);
      }
    }
    __syncwarp();
  }
}

// The sum's levels above the row on one warp, of L and (unless null) L2,
// up to the top level (<= 32 values at P.offs[top]).
__device__ __forceinline__ void sum_levels(float* L, float* L2,
                                           const RhScanPlan& P, int lane) {
  for (int j = 1; j < P.top; ++j) {
    for (int k = lane; k < P.sizes[j + 1]; k += 32) {
      const int at = P.offs[j + 1] + rh_lev_at(k, RH_SUM_WINDOW, P.fronts[j + 1]);
      L[at] = rh_sum_window(L + P.offs[j] + k, P.sizes[j], P.fronts[j], k);
      if (L2)
        L2[at] = rh_sum_window(L2 + P.offs[j] + k, P.sizes[j], P.fronts[j], k);
    }
    __syncwarp();
  }
}

template <bool SQ>
__global__ void __launch_bounds__(256)
    ordered_prefix_kernel(const float* __restrict__ x, long long stride,
                          float* __restrict__ out, float* __restrict__ out_sq,
                          long long ostride, int lead, int b, int n,
                          const __grid_constant__ RhScanPlan P) {
  extern __shared__ float4 sh4[];  // 16-byte aligned
  float* sh = reinterpret_cast<float*>(sh4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp % P.g;
  const int row = blockIdx.x * P.rows + warp / P.g;
  if (row >= b) return;  // only at a warp a row: no block barrier
  const int top = P.top;
  float* lev = sh + (warp / P.g) * P.row_floats;
  float* lev_sq = lev + P.lev;
  float* tiles = lev + (((SQ ? 2 : 1) * P.lev + 3) & ~3LL) +
                 w * (P.res + SQ) * RH_CT_FLOATS;
  float* sq_tile = SQ ? tiles + P.res * RH_CT_FLOATS : nullptr;
  const float* xr = x + row * stride;
  float* o = out + row * ostride + lead;
  float* osq = SQ ? out_sq + row * ostride + lead : nullptr;
  const int mine = w < P.rounds ? (P.rounds - 1 - w) / P.g + 1 : 0;
  RH_STAMP(0);
  RH_STAMP(1);

  // up-sweep: level 1, the blocks' totals
  rounds<true>(xr, n, 0, false, tiles, mine, P.res, w, P.g, lane,
               [&](int t, const float* tile) {
                 if (t == 0) RH_STAMP(2);  // the first round has landed
                 const int k = 32 * (t * P.g + w) + lane;
                 float a, s;
                 rh_ct_total(tile, lane, SQ, &a, &s);
                 if (top && k < P.units) {
                   const int at = rh_lev_at(k, RH_SCAN_BLOCK, 0);
                   lev[at] = a;
                   if (SQ) lev_sq[at] = s;
                 }
               });
  RH_STAMP(3);
  group_sync(P.g);
  RH_STAMP(4);
  // the levels above, on the row's first warp, the squares' on its second
  // when the row has more than one
  if (top) {
    if (SQ && P.g > 1) {
      if (w < 2) prefix_levels(w ? lev_sq : lev, nullptr, P, lane);
    } else if (w == 0) {
      prefix_levels(lev, SQ ? lev_sq : nullptr, P, lane);
    }
  }
  group_sync(P.g);
  RH_STAMP(5);

  // down-sweep: each block's running sums plus the blocks' prefix before it
  if (lead && w == 0 && lane == 0) {
    o[-1] = 0.0f;
    if (SQ) osq[-1] = 0.0f;
  }
  auto down = [&](int t, float* tile) {
    const int u = t * P.g + w;
    const int k = 32 * u + lane;
    const int pre = rh_lev_at(k - 1, RH_SCAN_BLOCK, 0);
    rh_ct_out(tile, sq_tile, lane, k ? lev[pre] : 0.0f,
              SQ && k ? lev_sq[pre] : 0.0f);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < RH_SCAN_BLOCK; ++q) {
      const int i = RH_CT_VALUES * u + 32 * q + lane;
      if (i < n) {
        o[i] = tile[rh_ct_slot(q, lane)];
        if (SQ) osq[i] = sq_tile[rh_ct_slot(q, lane)];
      }
    }
    __syncwarp();
  };
  if (mine <= P.res) {  // every round still in its own tile
    for (int t = 0; t < mine; ++t) down(t, tiles + t * RH_CT_FLOATS);
  } else {
    rounds<true>(xr, n, 0, false, tiles, mine, P.res, w, P.g, lane, down);
  }
  RH_STAMP(6);
  RH_STAMP(RH_STAMP_EXIT);
}

template <bool SQ>
__global__ void __launch_bounds__(256)
    ordered_sum_kernel(const float* __restrict__ x, long long stride,
                       float* __restrict__ out, float* __restrict__ out_sq,
                       int b, int n, const __grid_constant__ RhScanPlan P) {
  extern __shared__ float4 sh4[];  // 16-byte aligned
  float* sh = reinterpret_cast<float*>(sh4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp % P.g;
  const int row = blockIdx.x * P.rows + warp / P.g;
  if (row >= b) return;  // only at a warp a row: no block barrier
  const int top = P.top;
  const float* xr = x + row * stride;
  if (!top) {  // n <= 32: the row is the top level
    if (w == 0 && lane == 0) out[row] = rh_sum_top(xr, n, false);
    if (SQ && w == 0 && lane == 1) out_sq[row] = rh_sum_top(xr, n, true);
    return;
  }
  float* lev = sh + (warp / P.g) * P.row_floats;
  float* lev_sq = lev + P.lev;
  float* tiles = lev + (((SQ ? 2 : 1) * P.lev + 3) & ~3LL) + w * P.res * RH_ST_FLOATS;
  const int mine = w < P.rounds ? (P.rounds - 1 - w) / P.g + 1 : 0;
  RH_STAMP(0);
  RH_STAMP(1);

  // level 1, the windows' sums
  const bool vec = ((size_t)xr & 15) == 0 && P.fronts[0] % 4 == 0;
  rounds<false>(xr, n, P.fronts[0], vec, tiles, mine, P.res, w, P.g, lane,
                [&](int t, const float* tile) {
                  if (t == 0) RH_STAMP(2);  // the first round has landed
                  const int k = 32 * (t * P.g + w) + lane;
                  float a, s;
                  rh_st_total(tile, lane, SQ, &a, &s);
                  if (k < P.units) {
                    const int at = rh_lev_at(k, RH_SUM_WINDOW, P.fronts[1]);
                    lev[at] = a;
                    if (SQ) lev_sq[at] = s;
                  }
                });
  RH_STAMP(3);
  group_sync(P.g);
  RH_STAMP(4);
  // the levels above and the top, on the row's first warp, the squares' on
  // its second when the row has more than one
  const bool split = SQ && P.g > 1;
  if (w > (split ? 1 : 0)) {
    RH_STAMP(RH_STAMP_EXIT);
    return;
  }
  float* own = w ? lev_sq : lev;
  sum_levels(own, SQ && !split ? lev_sq : nullptr, P, lane);
  const int tp = P.offs[top];
  if (lane == 0) (w ? out_sq : out)[row] = rh_sum_top(own + tp, P.sizes[top], false);
  if (SQ && !split && lane == 1)
    out_sq[row] = rh_sum_top(lev_sq + tp, P.sizes[top], false);
  RH_STAMP(5);
  RH_STAMP(RH_STAMP_EXIT);
}

// the dynamic shared memory each kernel is allowed so far on each device
// (the attribute is a host call a launch would otherwise repeat, and it
// holds only for the device that was current when it was set); a launch
// that needs more raises it first
constexpr int kMaxDevices = 64;
std::atomic<int> g_smem_set[kMaxDevices][4];

int launch(const void* kernel, int which, const RhScanPlan& P, int b,
           void** args, cudaStream_t stream) {
  if (P.smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::atomic<int>& set = g_smem_set[dev][which];
    if (P.smem > set.load()) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)P.smem);
      if (e != cudaSuccess) return (int)e;
      int seen = set.load();
      while (seen < P.smem && !set.compare_exchange_weak(seen, (int)P.smem)) {
      }
    }
  }
  return (int)cudaLaunchKernel(kernel, dim3((b + P.rows - 1) / P.rows),
                               dim3(32 * P.g * P.rows), args, P.smem, stream);
}

}  // namespace

// Launch on `stream`; return a CUDA error code (0 on success).  x: device
// f32 rows of n values, row r at x + r * stride.  out (and out_sq, or
// null): device f32 rows, row r at out + r * ostride, of lead + n values:
// a leading 0 if lead, then the prefix sums of the row (of its squares).
// A row's levels above it must fit a block's 227 KB of shared memory (n up
// to ~800000; cudaErrorInvalidValue past it).
extern "C" int rh_ordered_prefix(const float* x, long long stride, float* out,
                                 float* out_sq, long long ostride, int lead,
                                 int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  RhScanPlan P;
  if (!rh_scan_plan(n, true, out_sq != nullptr, &P))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &stride, &out, &out_sq, &ostride, &lead, &b, &n, &P};
  return launch(out_sq ? (const void*)ordered_prefix_kernel<true>
                       : (const void*)ordered_prefix_kernel<false>,
                out_sq ? 1 : 0, P, b, args, (cudaStream_t)stream);
}

// The row sums of x (as above) into out[b] and, unless null, the sums of
// the rows' squares into out_sq[b].
extern "C" int rh_ordered_sum(const float* x, long long stride, float* out,
                              float* out_sq, int b, int n, void* stream) {
  if (b <= 0) return 0;
  RhScanPlan P;
  if (!rh_scan_plan(n, false, out_sq != nullptr, &P))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &stride, &out, &out_sq, &b, &n, &P};
  return launch(out_sq ? (const void*)ordered_sum_kernel<true>
                       : (const void*)ordered_sum_kernel<false>,
                out_sq ? 3 : 2, P, b, args, (cudaStream_t)stream);
}

#ifdef RH_SCAN_STAMPS
// The stamp build's buffer (RH_STAMPS words a warp of every launch's
// blocks), or null to stamp nothing; returns a CUDA error code.
extern "C" int rh_scan_set_stamps(long long* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof p);
}
#endif
