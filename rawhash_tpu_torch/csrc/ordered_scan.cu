// f32 row prefix sums and row sums in XLA's CPU order on Hopper (sm_90a):
// a block a row, the row's blocks of 16 (windows of 32) on its threads.
//
// Replaces jnp.cumsum and jnp.sum inside the jitted events program of the
// JAX package (rawhash_tpu/signal/events.py:287 detect_events_batch: the
// sums at :307-308, the prefix sums at :319 and :322, and :261 in
// _segment_events), which XLA's CPU backend adds in the order of
// ordered_scan.cuh; the port's plain versions, signal/events.py::
// ordered_cumsum_plain and ordered_sum_plain, dispatch a torch op an add.
//
// What bounds it: the bytes, each row read once and its sums written once
// (profiling/bounds.py::scan_bound); the adds are as many as the values.
//
// What the design does about it: the levels above the row (1/15 of it for
// the prefix sum, 1/31 for the sum) stay in shared memory, so the row is
// read from device memory in the up-sweep and again, from the L2 cache, in
// the prefix sum's down-sweep, and written once.  A thread's block of 16
// values is 64 contiguous bytes, so a warp's loads over a level cover whole
// lines.  A row's levels wait for each other (a __syncthreads() a level).
#include <cuda_runtime.h>

#include "ordered_scan.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ordered_cumsum_kernel(const float* __restrict__ x, long long stride,
                          float* __restrict__ out, int n) {
  extern __shared__ float sh[];
  int sizes[RH_SCAN_MAX_LEVELS], offs[RH_SCAN_MAX_LEVELS + 1];
  const int top = rh_cumsum_levels(n, sizes);
  offs[1] = 0;
  for (int j = 1; j < top; ++j) offs[j + 1] = offs[j] + sizes[j];
  const float* row = x + blockIdx.x * stride;
  float* dst0 = out + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  for (int j = 0; j < top; ++j) {
    const float* src = j ? sh + offs[j] : row;
    float* tot = sh + offs[j + 1];
    for (int k = tid; k < sizes[j + 1]; k += kThreads)
      tot[k] = rh_cumsum_block_total(src, sizes[j], k);
    __syncthreads();
  }
  if (tid == 0) {
    if (top) rh_cumsum_top(sh + offs[top], sizes[top], sh + offs[top]);
    else rh_cumsum_top(row, n, dst0);
  }
  __syncthreads();
  for (int j = top - 1; j >= 0; --j) {
    const float* src = j ? sh + offs[j] : row;
    float* dst = j ? sh + offs[j] : dst0;
    const float* pre = sh + offs[j + 1];
    for (int k = tid; k < sizes[j + 1]; k += kThreads)
      rh_cumsum_block_out(src, sizes[j], k, k ? pre[k - 1] : 0.0f, dst);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    ordered_sum_kernel(const float* __restrict__ x, long long stride,
                       float* __restrict__ out, int n) {
  extern __shared__ float sh[];
  int sizes[RH_SCAN_MAX_LEVELS], fronts[RH_SCAN_MAX_LEVELS],
      offs[RH_SCAN_MAX_LEVELS + 1];
  const int top = rh_sum_levels(n, sizes, fronts);
  offs[1] = 0;
  for (int j = 1; j < top; ++j) offs[j + 1] = offs[j] + sizes[j];
  const float* row = x + blockIdx.x * stride;
  const int tid = threadIdx.x;
  for (int j = 0; j < top; ++j) {
    const float* src = j ? sh + offs[j] : row;
    float* win = sh + offs[j + 1];
    for (int k = tid; k < sizes[j + 1]; k += kThreads)
      win[k] = rh_sum_window(src, sizes[j], fronts[j], k);
    __syncthreads();
  }
  if (tid == 0)
    out[blockIdx.x] = rh_sum_top(top ? sh + offs[top] : row, sizes[top]);
}

int launch(const void* kernel, long long scratch, const float* x,
           long long stride, float* out, int b, int n, void* stream) {
  const size_t smem = 4 * (size_t)scratch;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&x, &stride, &out, &n};
  return (int)cudaLaunchKernel(kernel, dim3(b), dim3(kThreads), args, smem,
                               (cudaStream_t)stream);
}

}  // namespace

// Launch on `stream`; return a CUDA error code (0 on success).  x: device
// f32 rows of n values, row r at x + r * stride; out: device f32, C-contiguous
// [b, n] (rh_ordered_cumsum) or [b] (rh_ordered_sum).  A row's levels above
// it must fit the block's 227 KB of shared memory (n up to ~850000 for the
// prefix sum, ~1.7 million for the sum).
extern "C" int rh_ordered_cumsum(const float* x, long long stride, float* out,
                                 int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  return launch((const void*)ordered_cumsum_kernel, rh_cumsum_scratch(n), x,
                stride, out, b, n, stream);
}

extern "C" int rh_ordered_sum(const float* x, long long stride, float* out,
                              int b, int n, void* stream) {
  if (b <= 0) return 0;
  return launch((const void*)ordered_sum_kernel, rh_sum_scratch(n), x, stride,
                out, b, n, stream);
}
