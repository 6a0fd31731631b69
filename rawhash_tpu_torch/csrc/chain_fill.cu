// Chaining DP fill on Hopper (sm_90a): independent chain segments on
// several warps per read.
//
// Replaces the Pallas kernel rawhash_tpu/chain/pallas_fill.py:
// chain_fill_pallas / _fill_kernel, and computes the same f and p bit for
// bit on rows sorted by (unsigned key, tpos), as
// map/device_step.py::merge_sort_fill sorts them (see chain_fill.cuh for the
// recurrence, the segments and the precondition; the kernel does not check
// the order).
//
// What bounds it: a segment is a serial chain (anchor i needs f of its
// in-band predecessors), and the work per step is small, so the kernel is
// latency-bound, not bandwidth- or FLOP-bound.  What the design does about
// it:
// - Segments.  A row splits where anchor i-1 is out of anchor i's band;
//   each segment is a DP of its own (chain_fill.cuh: rh_segment_start).
//   A block of `warps` warps serves one row (kWarps, or as many as their
//   rings fit at a large W: rh_fill_warps), and warp w fills the segments
//   whose first anchor lies in its share [w*n_a/warps, (w+1)*n_a/warps)
//   of the live anchors, running past the share's end until its last
//   segment ends.  Every f/p is written once, by one warp: no atomics and
//   no communication between warps.
// - A segment's first anchor needs no scan (f = q_span, p = -1): the warp
//   writes those 32 anchors at a time; only the later anchors of a segment
//   are stepped one by one.
// - The in-band suffix only: predecessors j = i-1, i-2, ... back to the
//   first one out of band or to max(i - W, segment start), as
//   rh_fill_segment scans them.  On a sorted row the suffix's far end never
//   moves back along a segment, so the warp finds it from the last step's
//   with a ballot over 32 predecessors (usually one), and then scores the
//   suffix 32 predecessors a round (lane l takes j = i-1-l-32c) with no
//   ballot between rounds (a ballot after each round, ending the scan at
//   the first predecessor out of band, would serialise the rounds).  The
//   pair score has no branches (rh_pair_total), so a round's 32 lanes run
//   in lockstep.  At D4's inputs the suffix is ~1 predecessor, not W = 200.
// - 32-bit warp reductions: (value, largest j) is two __reduce_max_sync
//   (redux.sync), on the value and then on j among the lanes holding it.
// - Each warp keeps a ring of its segment's anchors (key, tpos, qpos, f) in
//   its slice of shared memory: the W predecessors, the 32 anchors being
//   stepped and the next 32, fetched ahead of use with cp.async.  Ring
//   slots are incremented and wrapped, never taken modulo W.  f/p are
//   stored coalesced, 32 at a time.
// - Past the W at which not one ring fits a block's shared memory
//   (MAX_ITER_CAP = 14464 in chain/fill.py), the same kernel keeps each
//   warp's ring in a global-memory scratch buffer that the wrapper
//   allocates (kGlobalRing; layout rh_ring_offset in chain_fill.cuh),
//   staged with plain loads and stores that __syncwarp orders.  That path
//   is for correctness at any --max-iterations, not for speed: every ring
//   access is a global-memory (L1/L2) access.
#include <cuda_runtime.h>

#include "chain_fill.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warps per block, one block per read (fewer where their rings do not fit):
// of 4, 8 and 16, 16 fills the main path's own fill inputs fastest
// (chip_smoke.py's fill_warps phase times them on each run)
constexpr int kWarps = 16;

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int wrap(int s, int size) {
  return s >= size ? s - size : s;
}

// kGlobalRing: the rings are in `ring` (rh_ring_offset of blockIdx.x, the
// row within this launch), not in shared memory
template <bool kGlobalRing>
__global__ void __launch_bounds__(32 * kWarps)
    chain_fill_kernel(const int* __restrict__ key,
                      const int* __restrict__ tpos,
                      const int* __restrict__ qpos,
                      const int* __restrict__ n_anchors, int* __restrict__ f,
                      int* __restrict__ p, int n, RhParams P, int* ring) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int R = P.w + RH_FILL_AHEAD;  // ring slots of one warp
  int* rk = kGlobalRing ? ring + rh_ring_offset(blockIdx.x, warp, warps, P.w)
                        : smem + (size_t)warp * 4 * R;
  int* rt = rk + R;
  int* rq = rt + R;
  int* rf = rq + R;
  const size_t row = blockIdx.x;
  key += row * n;
  tpos += row * n;
  qpos += row * n;
  f += row * n;
  p += row * n;

  int n_a = n_anchors[row];
  n_a = n_a < 0 ? 0 : (n_a < n ? n_a : n);
  for (int i = n_a + threadIdx.x; i < n; i += blockDim.x) {
    f[i] = 0;
    p[i] = -1;
  }

  // this warp's share of the live anchors, and its first segment start
  const int lo = (int)((long long)n_a * warp / warps);
  const int hi = (int)((long long)n_a * (warp + 1) / warps);
  int s0 = hi;
  for (int a0 = lo; a0 < hi; a0 += 32) {
    const int a = a0 + lane;
    int start = 0;
    if (a < hi)
      start = rh_segment_start(a, a > 0 ? key[a - 1] : 0,
                               a > 0 ? tpos[a - 1] : 0, key[a], tpos[a], P);
    const unsigned b = __ballot_sync(kFull, start);
    if (b) {
      s0 = a0 + __ffs(b) - 1;
      break;
    }
  }
  if (s0 >= hi) return;  // no segment starts in the share

  // anchors [a0, a0 + 32) into ring slots from sl on, as one cp.async group
  // (plain copies into a global ring: the __syncwarp before the block is
  // read orders them)
  auto stage = [&](int a0, int sl) {
    const int a = a0 + lane;
    if (a < n_a) {
      const int s = wrap(sl + lane, R);
      if constexpr (kGlobalRing) {
        rk[s] = key[a];
        rt[s] = tpos[a];
        rq[s] = qpos[a];
      } else {
        cp_async4(rk + s, key + a);
        cp_async4(rt + s, tpos + a);
        cp_async4(rq + s, qpos + a);
      }
    }
    if constexpr (!kGlobalRing) cp_async_commit();
  };

  RhMii m = {-1, 0, 0, 0, RH_INT32_MIN};
  int seg = s0;  // first anchor of the segment being filled
  int st = s0;   // first in-band predecessor of the last stepped anchor
  int i0 = s0;   // first anchor of the block of 32 ...
  int bs = 0;    // ... and its ring slot
  stage(i0, bs);
  for (;;) {
    const int bs_next = wrap(bs + 32, R);
    __syncwarp();  // every lane is done with the slots the next block takes
    stage(i0 + 32, bs_next);
    if constexpr (!kGlobalRing) cp_async_wait_prev();
    __syncwarp();  // block i0 is in the ring, from every lane's copies

    const int a = i0 + lane;
    const int s = wrap(bs + lane, R);
    const bool live = a < n_a;
    int k_a = 0, t_a = 0, q_a = 0, start = 1;
    if (live) {
      k_a = rk[s];
      t_a = rt[s];
      q_a = rq[s];
      if (a != s0) {  // a-1 >= s0 is in the ring
        const int sp = s == 0 ? R - 1 : s - 1;
        start = rh_segment_start(a, rk[sp], rt[sp], k_a, t_a, P);
      }
    }
    // the warp's anchors end at the first segment start past its share
    const unsigned fin = __ballot_sync(kFull, !live || (a >= hi && start));
    const int cnt = fin ? __ffs(fin) - 1 : 32;
    const bool own = lane < cnt;
    const unsigned starts = __ballot_sync(kFull, own && start);
    unsigned steps = __ballot_sync(kFull, own && !start);
    int my_f = 0, my_p = -1;
    if (own && start) {
      my_f = P.q_span;
      rf[s] = P.q_span;
    }
    __syncwarp();

    while (steps) {
      const int u = __ffs(steps) - 1;
      steps &= steps - 1;
      const int i = i0 + u;
      const unsigned below = starts & ((1u << u) - 1);
      if (below) seg = i0 + 31 - __clz(below);
      const int si = wrap(bs + u, R);
      const int k_i = __shfl_sync(kFull, k_a, u);
      const int t_i = __shfl_sync(kFull, t_a, u);
      const int q_i = __shfl_sync(kFull, q_a, u);
      if (seg == i - 1) {  // second anchor: max_ii is the segment's first
        const int sp = rh_ring_back(si, 1, R);
        m = {i - 1, rk[sp], rt[sp], rq[sp], P.q_span};
      }

      // The far end of i's in-band suffix: the first predecessor in band,
      // from max(i - W, seg) on.  On a sorted row it never moves back along
      // a segment, so it is found from the last step's, 32 predecessors a
      // ballot (usually one); i-1 is in band, so the search ends.
      const int floor_j = i - P.w > seg ? i - P.w : seg;
      if (st < floor_j) st = floor_j;
      for (;;) {
        const int j = st + lane;
        int in = 0;
        if (j < i) {
          const int sj = rh_ring_back(si, i - j, R);
          in = rh_in_band(k_i, t_i, rk[sj], rt[sj], P);
        }
        const unsigned b = __ballot_sync(kFull, in);
        if (b) {
          st += __ffs(b) - 1;
          break;
        }
        st += 32;
      }
      // the suffix j = i-1 ... st, 32 predecessors a round; rounds share no
      // ballot, so their loads and scores overlap
      const int n_in = i - st;
      const int rounds = (n_in + 31) >> 5;
      RhScan acc = rh_scan_init();
#pragma unroll 4
      for (int r = 0; r < rounds; ++r) {
        const int d = 32 * r + lane + 1;  // predecessor j = i - d
        const bool mine = d <= n_in;
        const int sj = rh_ring_back(si, mine ? d : n_in, R);
        const int f_j = rf[sj];
        const int total =
            rh_pair_total(k_i, t_i, q_i, rk[sj], rt[sj], rq[sj], f_j, P);
        if (mine) rh_scan_add(acc, i - d, total, f_j);
      }
      RhWindow win;
      win.best = __reduce_max_sync(kFull, acc.best);
      win.best_j =
          __reduce_max_sync(kFull, acc.best == win.best ? acc.best_j : -1);
      win.re_f = __reduce_max_sync(kFull, acc.re_f);
      win.re_j = __reduce_max_sync(
          kFull, acc.re_j >= 0 && acc.re_f == win.re_f ? acc.re_j : -1);
      win.n_inband = n_in;  // >= 1: i-1 is in band
      const int rs = rh_ring_back(si, i - win.re_j, R);
      win.re_key = rk[rs];
      win.re_tpos = rt[rs];
      win.re_qpos = rq[rs];
      int fi, pi;
      rh_step(i, k_i, t_i, q_i, win, m, P, &fi, &pi);
      if (lane == 0) rf[si] = fi;
      if (lane == u) {
        my_f = fi;
        my_p = pi;
      }
      __syncwarp();  // f_i is in the ring for the next step
    }
    if (own) {
      f[a] = my_f;
      p[a] = my_p;
    }
    if (starts) seg = i0 + 31 - __clz(starts);
    if (cnt < 32) break;
    i0 += 32;
    bs = bs_next;
  }
  if constexpr (!kGlobalRing) cp_async_wait_all();
}

}  // namespace

// Launch on `stream` with at most `warps` warps a read (and at most
// kWarps); returns cudaGetLastError() (0 on success).  All pointers are
// device pointers to C-contiguous int32 arrays: key, tpos, qpos, f, p of
// shape [b, n], n_anchors of shape [b].  Each row's live anchors must be
// sorted by (unsigned key, tpos); this is not checked.  max_dist_t/q are
// already clamped to >= bw by the caller.  W = w needs one warp's ring to
// fit (rh_fill_warps(w, 1) == 1).
extern "C" int rh_chain_fill_warps(const int* key, const int* tpos,
                                   const int* qpos, const int* n_anchors,
                                   int* f, int* p, int b, int n, int w,
                                   int q_span, int max_dist_t, int max_dist_q,
                                   int bw, float pen_gap, float pen_skip,
                                   int warps, void* stream) {
  if (b <= 0) return 0;
  warps = rh_fill_warps(w, warps < kWarps ? warps : kWarps);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  RhParams P = {q_span, max_dist_t, max_dist_q, bw, w, pen_gap, pen_skip};
  const size_t smem = sizeof(int) * 4 * (size_t)(w + RH_FILL_AHEAD) * warps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_fill_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_fill_kernel<false><<<b, 32 * warps, smem, (cudaStream_t)stream>>>(
      key, tpos, qpos, n_anchors, f, p, n, P, nullptr);
  return (int)cudaGetLastError();
}

// The launch on kWarps warps a read: what chain/fill.py::chain_fill calls.
extern "C" int rh_chain_fill(const int* key, const int* tpos, const int* qpos,
                             const int* n_anchors, int* f, int* p, int b,
                             int n, int w, int q_span, int max_dist_t,
                             int max_dist_q, int bw, float pen_gap,
                             float pen_skip, void* stream) {
  return rh_chain_fill_warps(key, tpos, qpos, n_anchors, f, p, b, n, w,
                             q_span, max_dist_t, max_dist_q, bw, pen_gap,
                             pen_skip, kWarps, stream);
}

// The global-ring path's plan for a batch of b rows at W = w: warps a read
// and rows a launch, for a scratch of at most `budget` bytes (chain_fill.cuh:
// rh_fill_global_warps, rh_fill_global_rows).  The scratch the wrapper
// allocates holds rows * warps * rh_ring_ints(w) ints.
extern "C" void rh_chain_fill_global_plan(int b, int w, long long budget,
                                          int* warps, int* rows) {
  *warps = rh_fill_global_warps(w, kWarps, budget);
  *rows = rh_fill_global_rows(b, w, *warps, budget);
}

// The launch with the rings in `ring` (the plan's scratch), `rows` rows at
// a time; any W >= 1.  Returns the first launch's error (0 on success).
extern "C" int rh_chain_fill_global(const int* key, const int* tpos,
                                    const int* qpos, const int* n_anchors,
                                    int* f, int* p, int b, int n, int w,
                                    int q_span, int max_dist_t, int max_dist_q,
                                    int bw, float pen_gap, float pen_skip,
                                    int warps, int rows, int* ring,
                                    void* stream) {
  if (w < 1 || warps < 1 || warps > kWarps || rows < 1)
    return (int)cudaErrorInvalidValue;
  RhParams P = {q_span, max_dist_t, max_dist_q, bw, w, pen_gap, pen_skip};
  for (int r0 = 0; r0 < b; r0 += rows) {
    const int nb = b - r0 < rows ? b - r0 : rows;
    const size_t off = (size_t)r0 * n;
    chain_fill_kernel<true><<<nb, 32 * warps, 0, (cudaStream_t)stream>>>(
        key + off, tpos + off, qpos + off, n_anchors + r0, f + off, p + off, n,
        P, ring);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
