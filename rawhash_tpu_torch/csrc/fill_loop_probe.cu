// Fill-loop-overhead probe on Hopper (sm_90a): a serial ring of k_ops
// integer max steps a slot, built the way this card runs a serial ring
// best, so its time per iteration is the floor the port's serial kernels
// (K1's anchor step, the backtrack's walk step) are compared to.
//
// Replaces the Pallas probe tools/profiling/fill_loop_overhead.py: make
// (its kernel `kern`), and computes the same ring from the same start (see
// fill_loop_probe.cuh for the iteration).  The TPU kernel starts its ring
// and carry from uninitialised scratch; here the ring starts from x and the
// carry from INT32_MIN, which is what the Pallas interpreter gives.  Until
// this design it copied K1's first skeleton (a shared-memory ring, a 5-round
// shuffle max, two __syncwarp and i % W a step), which no kernel runs now.
//
// What bounds it: each column is a chain of n_iter dependent iterations
// (iteration i needs the column max of i - 1), and 256 columns put about 2
// warps on each of 132 SMs, so nothing hides a latency.  Its bound is that
// critical path, k_ops dependent VIADDMNMX (Hopper fuses each add with its
// max) and the column max an iteration, at latencies rh_probe_latencies
// measures on the card; neither its bytes (8 * W * B, once) nor its integer
// instructions (W * B * (k_ops + 1) an iteration) come near the card's rates.
//
// Design: one warp a column, one warp a block.  Up to W = 256 the column's
// ring lives in registers (probe_regs<SPL, K_OPS>): lane l holds slots
// l + 32 j in SPL = ceil(W/32) entries, chained interleaved (SPL-way ILP),
// written by an unrolled select, never indexed at run time.  The column max
// is the lane's tree max and one REDUX (__reduce_max_sync), which also joins
// the warp; the slot to write is a running counter.  For k_ops = 2, 20 and
// 60 (the entry point's) the chain is unrolled at compile time; any other
// k_ops takes the same kernel with a loop.  Past W = 256 the ring stays in
// shared memory (probe_smem<K_OPS>, up to 48 KB: W <= 12288), chained four
// slots at a time, with the same REDUX max and counter; each lane owns its
// slots there too, so no __syncwarp is needed.  There one warp's own
// instruction rate binds (one SM sub-partition's integer pipe).  x and out
// keep the JAX probe's [W, B] layout, read and written once at stride B.
#include <cuda_runtime.h>

#include "fill_loop_probe.cuh"

namespace {

template <int SPL, int K_OPS>
__global__ void __launch_bounds__(32)
    probe_regs(const int* __restrict__ x, int* __restrict__ out, int w, int b,
               int n_iter, int k_ops) {
  const int lane = threadIdx.x;
  const size_t col = blockIdx.x;
  RhProbeDevWarp::V<RhProbeRegs<SPL>> ring;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = lane + 32 * j;
    ring.v.r[j] = s < w ? x[(size_t)s * b + col] : RH_PROBE_INT32_MIN;
  }
  rh_probe_regs<SPL, K_OPS>(RhProbeDevWarp{}, ring, w, n_iter, k_ops);
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = lane + 32 * j;
    if (s < w) out[(size_t)s * b + col] = ring.v.r[j];
  }
}

template <int K_OPS>
__global__ void __launch_bounds__(32)
    probe_smem(const int* __restrict__ x, int* __restrict__ out, int w, int b,
               int n_iter, int k_ops) {
  extern __shared__ int ring[];
  const int lane = threadIdx.x;
  const size_t col = blockIdx.x;
  for (int s = lane; s < w; s += 32) ring[s] = x[(size_t)s * b + col];
  rh_probe_smem<K_OPS>(RhProbeDevWarp{}, ring, w, n_iter, k_ops);
  for (int s = lane; s < w; s += 32) out[(size_t)s * b + col] = ring[s];
}

struct Launch {
  const int* x;
  int* out;
  int w, b, n_iter, k_ops;
  cudaStream_t stream;
  template <int SPL, int K>
  int run() {
    if constexpr (SPL == 0)
      probe_smem<K><<<b, 32, 4 * (size_t)w, stream>>>(x, out, w, b, n_iter, k_ops);
    else
      probe_regs<SPL, K><<<b, 32, 0, stream>>>(x, out, w, b, n_iter, k_ops);
    return (int)cudaGetLastError();
  }
};

// ---- latencies and the int32 rate, by clock64 ------------------------------
// The counts below are LAT_* in profiling/fill_loop_overhead.py.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLatK = 60;       // chain steps an iteration (lat_chain, lat_rate)
constexpr int kLatRedux = 16;   // dependent REDUX an iteration (lat_redux)
constexpr int kLatSel = 16;     // compare-combine-select steps an iteration (lat_fsel)
constexpr int kRateThreads = 1024;  // 4 chains a thread, 2 blocks an SM

// one warp, n iterations of a kLatK-step chain a lane
__global__ void __launch_bounds__(32)
    lat_chain(const int* in, int* out, long long* cycles, int n) {
  int r = in[threadIdx.x];
  const int acc = in[32];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) r = rh_probe_run<kLatK>(r, acc, 0);
  asm volatile("" ::"r"(r));
  const long long t1 = clock64();
  out[threadIdx.x] = r;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// one warp, n iterations of kLatRedux dependent REDUX
__global__ void __launch_bounds__(32)
    lat_redux(const int* in, int* out, long long* cycles, int n) {
  int m = in[threadIdx.x];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < kLatRedux; ++u) m = __reduce_max_sync(kFull, m);
  }
  asm volatile("" ::"r"(m));
  const long long t1 = clock64();
  out[threadIdx.x] = m;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// one warp, n column maxima the way the old probe took them: 5 rounds of
// __shfl_xor_sync and a max
__global__ void __launch_bounds__(32)
    lat_shfl(const int* in, int* out, long long* cycles, int n) {
  int m = in[threadIdx.x];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int u = __shfl_xor_sync(kFull, m, o);
      m = u > m ? u : m;
    }
  }
  asm volatile("" ::"r"(m));
  const long long t1 = clock64();
  out[threadIdx.x] = m;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// one warp, n iterations of kLatSel dependent steps of the peak detector's
// kind, a select of the carried value on predicates of its compares:
// MAJ, the majority of three compares (nvcc 12.8 for sm_90a: FSETP ->
// FSETP.OR -> FSETP.AND -> PLOP3 -> FSEL a step), else their exclusive or
// (FSETP -> FSETP.XOR -> FSETP.XOR -> FSEL: the same chain without the
// PLOP3).  profiling/fill_loop_overhead.py::measure_latencies takes the
// FSETP -> PLOP3 -> SEL chain from the two.
template <bool MAJ>
__global__ void __launch_bounds__(32)
    lat_fsel(const int* in, int* out, long long* cycles, int n) {
  float x = (float)in[threadIdx.x];
  const float a = (float)in[31], b = (float)in[29], y = (float)in[30],
              e = (float)in[28];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < kLatSel; ++u) {
      const bool p1 = x > a - (float)u, p2 = x < b + (float)u,
                 p3 = x > e + (float)u;
      const bool q = MAJ ? (p1 && p2) || (p2 && p3) || (p1 && p3) : p1 ^ p2 ^ p3;
      x = q ? y - (float)u : x;
    }
  }
  asm volatile("" ::"f"(x));
  const long long t1 = clock64();
  out[threadIdx.x] = (int)x;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// every SM full (2 blocks of 1024 threads), 4 independent kLatK-step chains a
// thread, n iterations; each block's (SM id, first clock, last clock)
__global__ void __launch_bounds__(kRateThreads, 2)
    lat_rate(const int* in, int* out, long long* t, int n) {
  const int acc = in[32];
  int r0 = in[threadIdx.x & 31], r1 = r0 ^ 1, r2 = r0 ^ 2, r3 = r0 ^ 3;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    r0 = rh_probe_run<kLatK>(r0, acc, 0);
    r1 = rh_probe_run<kLatK>(r1, acc, 0);
    r2 = rh_probe_run<kLatK>(r2, acc, 0);
    r3 = rh_probe_run<kLatK>(r3, acc, 0);
  }
  __syncthreads();
  const long long t1 = clock64();
  out[(size_t)blockIdx.x * kRateThreads + threadIdx.x] = r0 ^ r1 ^ r2 ^ r3;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    t[3 * blockIdx.x] = sm;
    t[3 * blockIdx.x + 1] = t0;
    t[3 * blockIdx.x + 2] = t1;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x and out
// are device pointers to C-contiguous int32 arrays of shape [w, b],
// 1 <= w <= 12288 (the shared-memory ring, past 256, fits the default 48 KB).
extern "C" int rh_fill_loop_probe(const int* x, int* out, int w, int b,
                                  int n_iter, int k_ops, void* stream) {
  if (b <= 0) return 0;
  Launch l{x, out, w, b, n_iter, k_ops, (cudaStream_t)stream};
  return rh_probe_pick(w, k_ops, l);
}

// The card's latencies and int32 rate, in SM clock cycles, on `stream`:
// in holds 33 ints (32 lane values, then the carry), out blocks * 1024.
// cycles[0], [1]: lat_chain at n and 2n iterations; [2], [3]: lat_redux;
// [4], [5]: lat_shfl; [6], [7]: lat_fsel<true>; [8], [9]: lat_fsel<false>;
// then lat_rate's (SM, start, end) for each of `blocks` blocks of n_rate
// iterations.  Returns the first launch error, or 0.
extern "C" int rh_probe_latencies(const int* in, int* out, long long* cycles,
                                  int n, int n_rate, int blocks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < 2; ++k) {
    lat_chain<<<1, 32, 0, s>>>(in, out, cycles + k, n << k);
    lat_redux<<<1, 32, 0, s>>>(in, out, cycles + 2 + k, n << k);
    lat_shfl<<<1, 32, 0, s>>>(in, out, cycles + 4 + k, n << k);
    lat_fsel<true><<<1, 32, 0, s>>>(in, out, cycles + 6 + k, n << k);
    lat_fsel<false><<<1, 32, 0, s>>>(in, out, cycles + 8 + k, n << k);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  lat_rate<<<blocks, kRateThreads, 0, s>>>(in, out, cycles + 10, n_rate);
  return (int)cudaGetLastError();
}
