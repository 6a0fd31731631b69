// Fill-loop-overhead probe on Hopper (sm_90a): K1's loop skeleton with the
// scoring replaced by a chain of k_ops integer max steps.
//
// Replaces the Pallas probe tools/profiling/fill_loop_overhead.py: make
// (its kernel `kern`), and computes the same ring from the same start (see
// fill_loop_probe.cuh for the iteration).  The TPU kernel starts its ring
// and carry from uninitialised scratch; here the ring starts from x and the
// carry from INT32_MIN, which is what the Pallas interpreter gives.
//
// What bounds it: each column is a serial chain of n_iter dependent
// iterations (iteration i needs the column max of i - 1), and a 256-column
// batch puts about 2 warps on each of 132 SMs, so it is bound by latency:
// neither its bytes (x and out, 8 * W * B, once) nor its integer
// instructions (W * B * (k_ops + 1) per iteration: Hopper fuses each add with
// its max into one VIADDMNMX) come near the card's rates.
//
// Design: K1's skeleton (chain_fill.cu), deliberately, since the probe exists
// to time it.  One warp per column and one warp per block, as K1 runs one
// warp per read; the column's W-slot ring in shared memory, ceil(W/32) slots
// per lane (the last round masked when W is not a multiple of 32); the carry
// in a register, identical in every lane.  Each iteration every lane chains
// its slots, the column max is a local max then 5 __shfl_xor_sync rounds,
// the owner of slot i % W writes the max there, and two __syncwarp() run as
// in K1's step.  The ring stays in shared memory because K1's does: a
// register-resident ring is a design for K1's redesign, not for the probe
// that times K1 as it is.  x and out keep the JAX probe's [W, B] layout, so
// each lane loads and stores one word at stride B: 8 * W * B bytes once per
// call, nothing beside n_iter iterations.
#include <cuda_runtime.h>

#include "fill_loop_probe.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void fill_loop_probe_kernel(const int* __restrict__ x,
                                       int* __restrict__ out, int w, int b,
                                       int n_iter, int k_ops) {
  extern __shared__ int ring[];
  const int lane = threadIdx.x;
  const size_t col = blockIdx.x;
  for (int s = lane; s < w; s += 32) ring[s] = x[(size_t)s * b + col];
  __syncwarp();

  int acc = RH_PROBE_INT32_MIN;
  for (int i = 0; i < n_iter; ++i) {
    int m = RH_PROBE_INT32_MIN;
    for (int s = lane; s < w; s += 32) {
      const int r = rh_probe_chain(ring[s], acc, k_ops);
      ring[s] = r;
      m = r > m ? r : m;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int u = __shfl_xor_sync(kFull, m, o);
      m = u > m ? u : m;
    }
    acc = m;
    __syncwarp();  // every lane has written its chained slots
    const int slot = i % w;
    if (lane == (slot & 31)) ring[slot] = acc;
    __syncwarp();  // the write is visible to the next iteration
  }
  for (int s = lane; s < w; s += 32) out[(size_t)s * b + col] = ring[s];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x and out
// are device pointers to C-contiguous int32 arrays of shape [w, b]; the
// ring (4 * w bytes) fits the default 48 KB of shared memory.
extern "C" int rh_fill_loop_probe(const int* x, int* out, int w, int b,
                                  int n_iter, int k_ops, void* stream) {
  if (b <= 0) return 0;
  fill_loop_probe_kernel<<<b, 32, 4 * (size_t)w, (cudaStream_t)stream>>>(
      x, out, w, b, n_iter, k_ops);
  return (int)cudaGetLastError();
}
