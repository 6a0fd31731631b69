// Chaining DP fill on Hopper (sm_90a): one warp per read.
//
// Replaces the Pallas kernel rawhash_tpu/chain/pallas_fill.py:
// chain_fill_pallas / _fill_kernel, and computes the same f and p bit for
// bit (see chain_fill.cuh for the recurrence).
//
// What bounds it: each read is a serial chain of n_anchors steps (anchor i
// needs f of the W anchors before it), with W = max_iter (200 by default)
// predecessor scores per step.  The work per step is small and the chain is
// long, so the kernel is latency-bound, not bandwidth- or FLOP-bound.
//
// What the design does about it: reads run in parallel (one warp each, a
// block per read, so a 256-read batch puts ~2 warps on each of 132 SMs);
// inside a read the W predecessor scores of a step are spread over the 32
// lanes (ceil(W/32) slots each) and combined with warp shuffles, so a step
// costs a few shuffle rounds rather than W serial scores.  The ring of the
// last W anchors (key, tpos, qpos, f: 16*W bytes) lives in shared memory,
// anchors are loaded 32 at a time with one coalesced load per lane and
// broadcast by shuffle, and f/p are buffered in the lane that owns each
// anchor and stored coalesced.  The max_ii state is held in registers,
// identical in every lane.
#include <cuda_runtime.h>

#include "chain_fill.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// (value, j) as one signed 64-bit key whose order is lexicographic: the max
// picks the best value, and among equal values the largest j
__device__ __forceinline__ long long rh_pack(int v, int j) {
  unsigned long long hi = (unsigned long long)(uint32_t)v << 32;
  return (long long)(hi | (uint32_t)(j ^ 0x80000000u));
}
__device__ __forceinline__ int rh_pack_v(long long k) { return (int)(k >> 32); }
__device__ __forceinline__ int rh_pack_j(long long k) {
  return (int)((uint32_t)k ^ 0x80000000u);
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long u = __shfl_xor_sync(kFull, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__global__ void chain_fill_kernel(const int* __restrict__ key,
                                  const int* __restrict__ tpos,
                                  const int* __restrict__ qpos,
                                  const int* __restrict__ n_anchors,
                                  int* __restrict__ f, int* __restrict__ p,
                                  int n, RhParams P) {
  extern __shared__ int ring[];
  int* rk = ring;
  int* rt = ring + P.w;
  int* rq = ring + 2 * P.w;
  int* rf = ring + 3 * P.w;
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  key += row * n;
  tpos += row * n;
  qpos += row * n;
  f += row * n;
  p += row * n;

  for (int s = lane; s < P.w; s += 32) {
    rk[s] = rt[s] = rq[s] = 0;
    rf[s] = RH_INT32_MIN;
  }
  __syncwarp();

  int n_a = n_anchors[row];
  n_a = n_a < 0 ? 0 : (n_a < n ? n_a : n);
  RhMii m = {-1, 0, 0, 0, RH_INT32_MIN};
  for (int i0 = 0; i0 < n_a; i0 += 32) {
    const int ia = i0 + lane;
    int ck = 0, ct = 0, cq = 0;
    if (ia < n_a) {
      ck = key[ia];
      ct = tpos[ia];
      cq = qpos[ia];
    }
    int my_f = 0, my_p = -1;
    const int cnt = n_a - i0 < 32 ? n_a - i0 : 32;
    for (int u = 0; u < cnt; ++u) {
      const int i = i0 + u;
      const int k_i = __shfl_sync(kFull, ck, u);
      const int t_i = __shfl_sync(kFull, ct, u);
      const int q_i = __shfl_sync(kFull, cq, u);
      long long best = rh_pack(RH_INT32_MIN, RH_INT32_MIN);
      long long re = best;
      int nib = 0;
      for (int s = lane; s < P.w; s += 32) {
        const int j = rh_slot_anchor(i, s, P.w);
        const RhSlot r =
            rh_slot(k_i, t_i, q_i, rk[s], rt[s], rq[s], rf[s], j >= 0, P);
        const long long c = rh_pack(r.total, j);
        best = c > best ? c : best;
        if (r.in_band) {
          ++nib;
          const long long e = rh_pack(rf[s], j);
          re = e > re ? e : re;
        }
      }
      best = warp_max(best);
      re = warp_max(re);
      RhWindow win;
      win.best = rh_pack_v(best);
      win.best_j = rh_pack_j(best);
      win.n_inband = __reduce_add_sync(kFull, nib);
      win.re_j = rh_pack_j(re);
      if (win.n_inband > 0) {
        const int rs = win.re_j % P.w;
        win.re_key = rk[rs];
        win.re_tpos = rt[rs];
        win.re_qpos = rq[rs];
        win.re_f = rf[rs];
      } else {
        win.re_key = win.re_tpos = win.re_qpos = 0;
        win.re_f = RH_INT32_MIN;
      }
      int fi, pi;
      rh_step(i, k_i, t_i, q_i, win, m, P, &fi, &pi);
      __syncwarp();  // every lane has read the ring for this step
      if (lane == 0) {
        const int s = i % P.w;
        rk[s] = k_i;
        rt[s] = t_i;
        rq[s] = q_i;
        rf[s] = fi;
      }
      if (lane == u) {
        my_f = fi;
        my_p = pi;
      }
      __syncwarp();  // the write is visible to the next step
    }
    if (ia < n_a) {
      f[ia] = my_f;
      p[ia] = my_p;
    }
  }
  for (int i = n_a + lane; i < n; i += 32) {
    f[i] = 0;
    p[i] = -1;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to C-contiguous int32 arrays: key, tpos,
// qpos, f, p of shape [b, n], n_anchors of shape [b].  max_dist_t/q are
// already clamped to >= bw by the caller.
extern "C" int rh_chain_fill(const int* key, const int* tpos, const int* qpos,
                             const int* n_anchors, int* f, int* p, int b,
                             int n, int w, int q_span, int max_dist_t,
                             int max_dist_q, int bw, float pen_gap,
                             float pen_skip, void* stream) {
  if (b <= 0) return 0;
  RhParams P = {q_span, max_dist_t, max_dist_q, bw, w, pen_gap, pen_skip};
  const size_t smem = 16 * (size_t)w;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_fill_kernel<<<b, 32, smem, (cudaStream_t)stream>>>(
      key, tpos, qpos, n_anchors, f, p, n, P);
  return (int)cudaGetLastError();
}
