// Greedy all-chains backtrack on Hopper (sm_90a): one warp per read.
//
// Replaces both Pallas backtrack kernels of the reference package with one
// kernel at every anchor width:
//   K2  rawhash_tpu/chain/backtrack_pallas.py:147 backtrack_pallas (_kernel
//       :35, N <= 32768, all state in the TPU's SMEM);
//   K3  rawhash_tpu/chain/backtrack_pallas_big.py:361 backtrack_pallas_big
//       (_kernel :54, N > 32768, chain-stat mode).
// It returns K3's chain-stat contract (K2's six outputs plus the per-chain
// fuzzy lengths and first/last anchors), bit for bit; the per-read
// algorithm is rh_backtrack_read in chain_backtrack.cuh.  The candidate sort
// ((f, idx) ascending) runs before the launch, as in the reference package.
//
// What bounds it: each read is one serial chain of dependent loads, about
// 2N walk and claim steps plus up to N candidate probes, each a global load
// (p, then f or the claimed bit, of the node the previous load named).  Its
// byte bound is small (each input read once: ~24 bytes per anchor) and it
// does almost no arithmetic, so the kernel is latency-bound: a read's time
// is its step count times the latency of an L2 hit or a device-memory load.
//
// What the design does about it: the claimed marks, the only read-write
// state, are a bitmask in shared memory (N/32 words: 32 KB at N = 2^18), so
// a mark costs a shared-memory access, not a global one; the walks read f, p,
// tpos and qpos straight from global memory, and the working set of the
// reads in flight (~16 N bytes each) sits in the 50 MB L2.  Reads run in
// parallel, one block each.  v and the chain rows are appended in place,
// because a chain is accepted before its claim walk.  Visit stamps are dead
// (p[i] < i), so there is no second mark plane.
#include <cuda_runtime.h>

#include "chain_backtrack.cuh"

namespace {

__global__ void chain_backtrack_kernel(
    const int* __restrict__ zf, const int* __restrict__ zi,
    const int* __restrict__ f, const int* __restrict__ p,
    const int* __restrict__ tpos, const int* __restrict__ qpos,
    int* __restrict__ v, int* __restrict__ u_sc, int* __restrict__ u_cnt,
    int* __restrict__ u_ml, int* __restrict__ u_bl, int* __restrict__ u_lo,
    int* __restrict__ u_hi, int* __restrict__ n_u, int* __restrict__ n_v,
    int* __restrict__ ovf, RhBtParams P) {
  extern __shared__ uint32_t claimed[];
  const size_t row = blockIdx.x;
  const int words = (P.n + 31) >> 5;
  for (int w = threadIdx.x; w < words; w += blockDim.x) claimed[w] = 0u;
  __syncwarp();
  if (threadIdx.x != 0) return;
  const size_t a = row * (size_t)P.n;
  const size_t u = row * (size_t)P.k_cap;
  const RhBtCounts c = rh_backtrack_read(
      zf + a, zi + a, f + a, p + a, tpos + a, qpos + a, claimed, v + a,
      u_sc + u, u_cnt + u, u_ml + u, u_bl + u, u_lo + u, u_hi + u, P);
  n_u[row] = c.n_u;
  n_v[row] = c.n_v;
  ovf[row] = c.ovf;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Device
// pointers to C-contiguous int32 arrays: zf, zi, f, p, tpos, qpos, v of shape
// [b, n]; u_* of shape [b, k_cap]; n_u, n_v, ovf of shape [b].  The outputs
// must be zero on entry (entries past n_u / n_v are not written).
extern "C" int rh_chain_backtrack(
    const int* zf, const int* zi, const int* f, const int* p, const int* tpos,
    const int* qpos, int* v, int* u_sc, int* u_cnt, int* u_ml, int* u_bl,
    int* u_lo, int* u_hi, int* n_u, int* n_v, int* ovf, int b, int n,
    int k_cap, int min_cnt, int min_sc, int max_drop, int q_span,
    void* stream) {
  if (b <= 0) return 0;
  const RhBtParams P = {n, k_cap, min_cnt, min_sc, max_drop, q_span};
  const size_t smem = 4 * (size_t)((n + 31) / 32);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_backtrack_kernel<<<b, 32, smem, (cudaStream_t)stream>>>(
      zf, zi, f, p, tpos, qpos, v, u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi, n_u,
      n_v, ovf, P);
  return (int)cudaGetLastError();
}
