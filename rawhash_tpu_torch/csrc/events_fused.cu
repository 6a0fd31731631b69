// The events stage of a chunk on Hopper (sm_90a) in three launches: the
// statistics, normalisation, clip and t-statistics (events_norm_kernel, a
// block a row), the dual peak detector (events_peaks.cu's kernel, through
// rh_events_peaks), and the segments' IQR-filtered means
// (events_segments_kernel, a block a row).  The row programs are
// rh_ev_norm_row and rh_ev_segments_row in events_fused.cuh.
//
// Replaces, on CUDA tensors, the 293 torch ops that
// signal/events.py::detect_events_batch dispatched a chunk around K5 and
// K6 (the JAX package compiles the same stage into one program,
// rawhash_tpu/signal/events.py:287): the host now allocates the outputs and
// one workspace and makes one call, and the calling thread no longer takes
// the GIL an op at a time.
//
// What bounds it: the peak detector's serial chain over the longest row
// (profiling/bounds.py::peaks_bound); the two row programs are a few
// passes over a row each, in shared memory, with a barrier between phases.
//
// What the design does about it:
//   - a row's intermediate values (the signal, the clipped row, its prefix
//     sums and the levels above them; the sorted keys, the peaks and the
//     segments' bounds) stay in the block's shared memory when the row fits
//     it (4000 samples: ~38 KB and ~60 KB), else in a global scratch of the
//     workspace, a row's region each: the kernels take the layout their row
//     width gives, never a flag;
//   - the sums and prefix sums are ordered_scan.cuh's own block functions on
//     rows staged in its padded layouts (a float of padding a block or
//     window, so the lanes, a block each, read distinct banks);
//   - the row-wide (segment, value) sort of the plain version becomes a
//     sort of each segment's values where they lie: a thread a segment
//     (insertion; the segments hold ~9 values), the block on a segment of
//     more than 64 (a bitonic network, through a shared-memory tile for a
//     row in global memory);
//   - the input signal is read as the engine sends it (f16, widened in the
//     kernel as torch widens it) or f32, so no conversion is launched.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>

__device__ __forceinline__ float rh_ev_widen(__half x) { return __half2float(x); }

#include "events_fused.cuh"

extern "C" int rh_events_peaks(const float* ts1, const float* ts2,
                               const int* n_sig, int* out, int b, int l,
                               float t1, float t2, float ph, int w1, int half1,
                               int half2, void* stream);

namespace {

// a block is the team of its row
struct BlockTeam {
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f((int)threadIdx.x, (int)blockDim.x);
    __syncthreads();
  }
  __device__ __forceinline__ int size() const { return (int)blockDim.x; }
  __device__ __forceinline__ void atomic_add(int* p, int v) { atomicAdd(p, v); }
};

template <class In, bool WIDE>
__global__ void __launch_bounds__(RH_EV_THREADS)
    events_norm_kernel(const In* __restrict__ sig, long long stride,
                       const int* __restrict__ slen,
                       const float* __restrict__ c_sum,
                       const float* __restrict__ c_sq,
                       const int* __restrict__ c_n, float* o_sum, float* o_sq,
                       int* o_n, float* normc, int* n_sig, float* ts1,
                       float* ts2, float* scratch, int l,
                       const __grid_constant__ RhEvNormPlan P, RhEvParams E) {
  extern __shared__ float4 sh4[];
  __shared__ int part[RH_EV_PART];
  const long long row = blockIdx.x;
  float* r = WIDE ? scratch + row * P.words : reinterpret_cast<float*>(sh4);
  BlockTeam tm;
  rh_ev_norm_row(tm, P, E, sig + row * stride, l, slen[row], c_sum[row],
                 c_sq[row], c_n[row], r, part, normc + row * l, ts1 + row * l,
                 ts2 + row * l, o_sum + row, o_sq + row, o_n + row, n_sig + row);
}

template <bool WIDE>
__global__ void __launch_bounds__(RH_EV_THREADS)
    events_segments_kernel(const int* __restrict__ em,
                           const float* __restrict__ normc,
                           const int* __restrict__ n_sig, float* ev, int* n_ev,
                           float* scratch, int l, int e_cap,
                           const __grid_constant__ RhEvSegPlan P) {
  extern __shared__ float4 sh4[];
  __shared__ int part[RH_EV_PART];
  const long long row = blockIdx.x;
  // where the row's scratch is global, the dynamic shared memory is the tile
  float* r = WIDE ? scratch + row * P.words : reinterpret_cast<float*>(sh4);
  unsigned* tile = WIDE ? reinterpret_cast<unsigned*>(sh4) : nullptr;
  BlockTeam tm;
  rh_ev_segments_row(tm, P, em + row * 2 * l, normc + row * l, n_sig[row], l,
                     e_cap, r, part, tile, ev + row * e_cap, n_ev + row);
}

// the dynamic shared memory each kernel is allowed so far on each device (a
// launch that needs more raises it first; the attribute holds for the
// device current when it is set)
constexpr int kMaxDevices = 64, kKernels = 6;
std::atomic<int> g_smem_set[kMaxDevices][kKernels];

int launch(const void* kernel, int which, long long smem, int b, void** args,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::atomic<int>& set = g_smem_set[dev][which];
    if (smem > set.load()) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      int seen = set.load();
      while (seen < smem && !set.compare_exchange_weak(seen, (int)smem)) {
      }
    }
  }
  return (int)cudaLaunchKernel(kernel, dim3(b), dim3(RH_EV_THREADS), args,
                               (size_t)smem, stream);
}

// The workspace: normc, ts1, ts2 f32 [b, l], the emissions i32 [b, 2 l],
// n_sig i32 [b], then the global scratch of the row programs that do not
// fit shared memory (a region a row, the larger program's); byte offsets,
// each a multiple of 256.
struct Layout {
  RhEvNormPlan norm;
  RhEvSegPlan seg;
  bool wide_norm, wide_seg;
  long long ts1, ts2, em, n_sig, scratch, bytes;
};

long long up256(long long n) { return (n + 255) & ~255LL; }

void layout(int b, int l, int e_cap, Layout* L) {
  rh_ev_norm_plan(l, &L->norm);
  rh_ev_seg_plan(l, e_cap, &L->seg);
  L->wide_norm = !rh_ev_fits_shared(L->norm.words);
  L->wide_seg = !rh_ev_fits_shared(L->seg.words);
  const long long plane = up256(4LL * b * l);
  L->ts1 = plane;
  L->ts2 = 2 * plane;
  L->em = 3 * plane;
  L->n_sig = L->em + up256(8LL * b * l);
  L->scratch = L->n_sig + up256(4LL * b);
  long long words = 0;
  if (L->wide_norm) words = L->norm.words;
  if (L->wide_seg && L->seg.words > words) words = L->seg.words;
  L->bytes = L->scratch + 4 * words * b;
}

}  // namespace

// The workspace's bytes for a chunk of b rows of l samples and e_cap
// events; *wide: 1 if the first row program stages its rows in the global
// scratch, + 2 if the second does.
extern "C" long long rh_events_fused_workspace(int b, int l, int e_cap,
                                               int* wide) {
  Layout L;
  layout(b, l, e_cap, &L);
  *wide = (L.wide_norm ? 1 : 0) | (L.wide_seg ? 2 : 0);
  return L.bytes;
}

// Launch the stage on `stream`; returns a CUDA error code (0 on success).
// Device pointers, C-contiguous: sig [b, l] rows at sig + r * stride, f16
// (half) or f32; slen, c_n i32 [b]; c_sum, c_sq f32 [b]; ev f32 [b, e_cap];
// n_ev, o_n i32 [b]; o_sum, o_sq f32 [b]; ws the workspace
// (rh_events_fused_workspace's bytes, 256-byte aligned).  b, l >= 1.
extern "C" int rh_events_fused(const void* sig, long long stride, int half,
                               const int* slen, const float* c_sum,
                               const float* c_sq, const int* c_n, float* ev,
                               int* n_ev, float* o_sum, float* o_sq, int* o_n,
                               void* ws, int b, int l, int e_cap, float t1,
                               float t2, float ph, int w1, int w2,
                               void* stream) {
  if (b <= 0 || l <= 0) return (int)cudaErrorInvalidValue;
  Layout L;
  layout(b, l, e_cap, &L);
  char* base = static_cast<char*>(ws);
  float* normc = reinterpret_cast<float*>(base);
  float* ts1 = reinterpret_cast<float*>(base + L.ts1);
  float* ts2 = reinterpret_cast<float*>(base + L.ts2);
  int* em = reinterpret_cast<int*>(base + L.em);
  int* n_sig = reinterpret_cast<int*>(base + L.n_sig);
  float* scratch = reinterpret_cast<float*>(base + L.scratch);
  const RhEvParams E = rh_ev_params(w1, w2);
  cudaStream_t st = (cudaStream_t)stream;

  const void* norm_kernels[4] = {
      (const void*)events_norm_kernel<float, false>,
      (const void*)events_norm_kernel<float, true>,
      (const void*)events_norm_kernel<__half, false>,
      (const void*)events_norm_kernel<__half, true>};
  const int which = 2 * (half ? 1 : 0) + (L.wide_norm ? 1 : 0);
  void* args1[] = {(void*)&sig, &stride, &slen, &c_sum, &c_sq, &c_n, &o_sum,
                   &o_sq, &o_n, &normc, &n_sig, &ts1, &ts2, &scratch, &l,
                   &L.norm, (void*)&E};
  int rc = launch(norm_kernels[which], which,
                  L.wide_norm ? 0 : 4 * L.norm.words, b, args1, st);
  if (rc) return rc;

  rc = rh_events_peaks(ts1, ts2, n_sig, em, b, l, t1, t2, ph, w1, w1 / 2,
                       w2 / 2, stream);
  if (rc) return rc;

  const void* seg_kernel = L.wide_seg ? (const void*)events_segments_kernel<true>
                                      : (const void*)events_segments_kernel<false>;
  void* args3[] = {&em, &normc, &n_sig, &ev, &n_ev, &scratch, &l, &e_cap, &L.seg};
  return launch(seg_kernel, 4 + (L.wide_seg ? 1 : 0),
                L.wide_seg ? 4 * RH_EV_TILE : 4 * L.seg.words, b, args3, st);
}
