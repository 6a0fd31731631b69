// Greedy all-chains backtrack on Hopper (sm_90a): one warp per read, 32
// candidates a round.
//
// Replaces both Pallas backtrack kernels of the reference package with one
// kernel at every anchor width:
//   K2  rawhash_tpu/chain/backtrack_pallas.py:147 backtrack_pallas (_kernel
//       :35, N <= 32768, all state in the TPU's SMEM);
//   K3  rawhash_tpu/chain/backtrack_pallas_big.py:361 backtrack_pallas_big
//       (_kernel :54, N > 32768, chain-stat mode).
// It returns K3's chain-stat contract (K2's six outputs plus the per-chain
// fuzzy lengths and first/last anchors), bit for bit; the per-read
// algorithm is rh_backtrack_rounds in chain_backtrack.cuh.  The candidate
// order (the anchors with f >= min_sc, compacted, then sorted by (f, idx))
// is built before the launch, as the reference package sorts outside its
// Pallas kernels.
//
// What bounds it: each read is a serial chain of dependent steps (candidate
// visits, walk-A steps, claim steps: profiling/bounds.py::backtrack_work),
// each a load of the node the previous load named.  Its bytes and
// operations are small next to that, so the kernel is latency-bound: a
// read's time is its longest chain of dependent loads times their latency,
// and the kernel's time that of its slowest read.
//
// What the design does about it:
//   - only the candidates (f >= min_sc) enter the order, 5% of D4's anchors;
//   - 32 candidates a round: their order and claimed bits are read with one
//     coalesced load (a round ahead) and one ballot, so a claimed candidate
//     costs a lane of a round, not a dependent load;
//   - the 32 candidates' walks run ahead at once, read-only, into a staging
//     buffer in shared memory (up to `depth` steps each), with tpos/qpos of
//     the nodes an accepted walk keeps, so 32 chains of dependent loads are
//     in flight instead of one;
//   - a candidate whose staged walk stopped by itself and met no claim made
//     since the round began keeps its staged result, and its own lane claims
//     its nodes and writes the chain from the staging buffer; the others
//     are resolved by the whole warp (the cut walk by ballots and a warp
//     max, the claim walk 32 nodes a chunk);
//   - the claimed bits are a bitmask in shared memory at every width, so any
//     width whose bitmask fits (MAX_WIDTH in chain/backtrack.py) runs; the
//     staging depth shrinks only where the bitmask leaves it no room.
// f and p stay in global memory: a copy in shared memory (tried: where a
// read's f, p and bits fit, ~28000 anchors) took 1.5x as long at 256 x
// 16384, one ~137 KB block an SM running the reads in two waves, and lost
// on D2's own tail call too (PERF.md).
#include <cuda_runtime.h>

#include "chain_backtrack.cuh"

namespace {

__global__ void chain_backtrack_kernel(
    const int* __restrict__ zf, const int* __restrict__ zi,
    const int* __restrict__ n_cand, const int* __restrict__ f,
    const int* __restrict__ p,
    const int* __restrict__ tpos, const int* __restrict__ qpos,
    int* __restrict__ v, int* __restrict__ u_sc, int* __restrict__ u_cnt,
    int* __restrict__ u_ml, int* __restrict__ u_bl, int* __restrict__ u_lo,
    int* __restrict__ u_hi, int* __restrict__ n_u, int* __restrict__ n_v,
    int* __restrict__ ovf, RhBtParams P, int c, int a_max, int depth) {
  extern __shared__ uint32_t sh[];
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const int words = (a_max + 31) >> 5;
  const int st = depth > 0 ? 32 * rh_bt_stride(depth) : 0;
  uint32_t* claimed = sh;
  int* buf = (int*)(sh + words);
  const RhBtStage stage = {buf, buf + st, buf + 2 * st, buf + 3 * st};
  for (int w = lane; w < words; w += 32) claimed[w] = 0u;
  __syncwarp();
  const size_t a = row * (size_t)P.n;
  const size_t z = row * (size_t)c;
  const size_t u = row * (size_t)P.k_cap;
  const RhBtRow R = {
      zf + z, zi + z, c - n_cand[row], c, f + a, p + a, tpos + a, qpos + a,
      v + a, u_sc + u, u_cnt + u, u_ml + u, u_bl + u, u_lo + u, u_hi + u};
  const RhBtCounts k =
      rh_backtrack_rounds(RhDevWarp{}, R, claimed, stage, depth, P);
  if (lane == 0) {
    n_u[row] = k.n_u;
    n_v[row] = k.n_v;
    ovf[row] = k.ovf;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Device
// pointers to C-contiguous int32 arrays: zf, zi of shape [b, c] (each row's
// n_cand candidates at its top, (f, idx) ascending); n_cand of shape [b];
// f, p, tpos, qpos, v of shape [b, n]; u_* of shape [b, k_cap]; n_u, n_v,
// ovf of shape [b].  a_max: every anchor a walk can reach is below it (the
// largest n_anchors, clipped to n).  depth in [0, 32]: the steps a lane
// stages.  Shared memory: 4 ceil(a_max / 32) bytes of claimed bits and
// 512 (depth + 1) of staging (none at depth 0), as chain/backtrack.py::
// shared_bytes counts it.  The outputs must be zero on entry (entries past
// n_u / n_v are not written).
extern "C" int rh_chain_backtrack(
    const int* zf, const int* zi, const int* n_cand, const int* f,
    const int* p, const int* tpos, const int* qpos, int* v, int* u_sc,
    int* u_cnt, int* u_ml, int* u_bl, int* u_lo, int* u_hi, int* n_u,
    int* n_v, int* ovf, int b, int n, int c, int a_max, int k_cap,
    int min_cnt, int min_sc, int max_drop, int q_span, int depth,
    void* stream) {
  if (b <= 0) return 0;
  if (depth < 0 || depth > 32 || a_max < 1 || a_max > n || c < 1)
    return (int)cudaErrorInvalidValue;
  const RhBtParams P = {n, k_cap, min_cnt, min_sc, max_drop, q_span};
  const size_t smem = 4 * (size_t)((a_max + 31) / 32) +
                      (depth > 0 ? 512 * (size_t)(depth + 1) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_backtrack_kernel<<<b, 32, smem, (cudaStream_t)stream>>>(
      zf, zi, n_cand, f, p, tpos, qpos, v, u_sc, u_cnt, u_ml, u_bl, u_lo,
      u_hi, n_u, n_v, ovf, P, c, a_max, depth);
  return (int)cudaGetLastError();
}
