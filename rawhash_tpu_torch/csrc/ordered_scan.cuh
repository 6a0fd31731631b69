// f32 row sums and prefix sums in one fixed order, the order XLA's CPU
// backend gives jnp.sum and jnp.cumsum (signal/events.py::ordered_sum_plain
// and ordered_cumsum_plain).  Shared by the CUDA kernels (ordered_scan.cu)
// and a host build of the same logic (ordered_scan_host.cpp, which the CPU
// tests build with g++).  Every add is a separate f32 add in the order
// written here, so every build gives the plain versions' sums bit for bit.
//
// Prefix sum of n values, by levels: level 0 is the row; while a level has
// more than 16 values, the next level holds the totals of its blocks of 16
// (zero past its end), each summed left to right from 0.  The top level
// (<= 16 values) is scanned left to right from 0.  Then, from the top down,
// each block's running sums plus the prefix of the blocks before it (0 for
// the first) replace the block: its scan.
//
// Sum of n values, by levels: while a level has more than 32 values, it is
// padded with zeros to a multiple of 32, half the padding in front, and the
// next level holds its windows of 32, each summed left to right from 0.
// The top level (<= 32 values) is summed left to right from 0.
//
// A sum starts from +0, so it is never -0 and an added zero (the padding)
// leaves it as it is.  The square of a value (the `sq` sums) is one f32
// multiply, rounded once, as a torch multiply rounds it.
//
// Level 0 runs in rounds: a warp's round is 32 prefix blocks (512 values)
// or 32 sum windows (1024 values), staged in a tile of shared memory (a
// "prefix tile", 32 x 17 floats, or a "sum tile", 32 x 32), lane c taking
// block or window c.  Value 32 q + lane of a round goes to the tile slot
// rh_ct_slot / rh_st_slot(q, lane), so a warp's loads and stores of a round
// are 128 contiguous bytes each and its lanes' tile rows sit in different
// banks.  A sum tile's rows keep their 16-byte chunks whole, in an order
// swizzled by the row (rh_st_at), so that a row whose values start on 16
// bytes can be staged 4 values a lane (rh_st_slot4) and a lane reads its
// window 4 values at a time, 8 lanes of a warp on 8 distinct bank groups.
// A row's rounds go to its G warps in turn (round u to warp u % G, the
// warp's t-th being u = t G + w); a warp has `res` tiles, the copies of
// the next rounds in flight while it works one (the kernels), or staged
// `res` rounds at a time (the host build); the kernels and the host build
// share the plan (rh_scan_plan, a function of the row's length) and these
// functions.
#pragma once

#ifdef __CUDACC__
#define RH_SC_HD __host__ __device__ __forceinline__
#define RH_SC_TEAM __device__ __forceinline__
#define RH_SC_UNROLL _Pragma("unroll")
#else
#define RH_SC_HD static inline
#define RH_SC_TEAM static inline
#define RH_SC_UNROLL
#endif

#define RH_SCAN_BLOCK 16
#define RH_SUM_WINDOW 32
// levels of a row of up to 2^31 values (a level is 1/16 of the one below)
#define RH_SCAN_MAX_LEVELS 9
// a prefix tile: block c's value r at c * RH_CT_STRIDE + r
#define RH_CT_STRIDE 17
#define RH_CT_FLOATS (32 * RH_CT_STRIDE)
#define RH_CT_VALUES (32 * RH_SCAN_BLOCK)
// a sum tile: window c's value r at rh_st_at(c, r), rows of 32 floats
#define RH_ST_FLOATS (32 * RH_SUM_WINDOW)
#define RH_ST_VALUES (32 * RH_SUM_WINDOW)
// shared memory a block of the kernels may take (bytes)
#define RH_SCAN_SMEM_BUDGET (100 * 1024)
#define RH_SCAN_SMEM_MAX (227 * 1024)

// The prefix sum's level sizes (sizes[0] = n); returns the top level's index.
RH_SC_HD int rh_cumsum_levels(int n, int* sizes) {
  int j = 0;
  sizes[0] = n;
  while (sizes[j] > RH_SCAN_BLOCK) {
    sizes[j + 1] = (sizes[j] + RH_SCAN_BLOCK - 1) / RH_SCAN_BLOCK;
    ++j;
  }
  return j;
}

// (Each function below loads its values before it adds them, so that the
// loads do not wait on the adds; the adds keep their order.)

// The total of block k of src (n values, zero past them), or (sq) of
// their squares.
RH_SC_HD float rh_cumsum_block_total(const float* src, int n, int k,
                                     bool sq = false) {
  const int a = k * RH_SCAN_BLOCK;
  float v[RH_SCAN_BLOCK];
  RH_SC_UNROLL
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) v[r] = a + r < n ? src[a + r] : 0.0f;
  float acc = 0.0f;
  RH_SC_UNROLL
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) acc = acc + (sq ? v[r] * v[r] : v[r]);
  return acc;
}

// Block k's running sums plus carry, the prefix of the blocks before it,
// into dst (may be src), up to n; unless dst_sq is null, its squares'
// running sums plus carry_sq into dst_sq.
RH_SC_HD void rh_cumsum_block_out(const float* src, int n, int k, float carry,
                                  float* dst, float carry_sq = 0.0f,
                                  float* dst_sq = nullptr) {
  const int a = k * RH_SCAN_BLOCK;
  float v[RH_SCAN_BLOCK];
  RH_SC_UNROLL
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) v[r] = a + r < n ? src[a + r] : 0.0f;
  float acc = 0.0f, s = 0.0f;
  RH_SC_UNROLL
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) {
    acc = acc + v[r];
    if (a + r < n) dst[a + r] = acc + carry;
    if (dst_sq) {
      s = s + v[r] * v[r];
      if (a + r < n) dst_sq[a + r] = s + carry_sq;
    }
  }
}

// The top level's scan (n <= 16), into dst (may be src).
RH_SC_HD void rh_cumsum_top(const float* src, int n, float* dst) {
  float v[RH_SCAN_BLOCK];
  RH_SC_UNROLL
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) v[r] = r < n ? src[r] : 0.0f;
  float acc = 0.0f;
  RH_SC_UNROLL
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) {
    acc = acc + v[r];
    if (r < n) dst[r] = acc;
  }
}

// The sum's level sizes (sizes[0] = n) and each level's front padding;
// returns the top level's index.
RH_SC_HD int rh_sum_levels(int n, int* sizes, int* fronts) {
  int j = 0;
  sizes[0] = n;
  while (sizes[j] > RH_SUM_WINDOW) {
    const int p = (RH_SUM_WINDOW - sizes[j] % RH_SUM_WINDOW) % RH_SUM_WINDOW;
    fronts[j] = p / 2;
    sizes[j + 1] = (sizes[j] + p) / RH_SUM_WINDOW;
    ++j;
  }
  return j;
}

// Window k of src (n values after `front` zeros, zeros past them), or (sq)
// of their squares.
RH_SC_HD float rh_sum_window(const float* src, int n, int front, int k,
                             bool sq = false) {
  const int a = k * RH_SUM_WINDOW - front;
  float v[RH_SUM_WINDOW];
  RH_SC_UNROLL
  for (int r = 0; r < RH_SUM_WINDOW; ++r)
    v[r] = a + r >= 0 && a + r < n ? src[a + r] : 0.0f;
  float acc = 0.0f;
  RH_SC_UNROLL
  for (int r = 0; r < RH_SUM_WINDOW; ++r) acc = acc + (sq ? v[r] * v[r] : v[r]);
  return acc;
}

// The top level's sum (n <= 32), of the values or (sq) of their squares
// (the zeros added past n leave it as it is).
RH_SC_HD float rh_sum_top(const float* src, int n, bool sq) {
  float v[RH_SUM_WINDOW];
  RH_SC_UNROLL
  for (int r = 0; r < RH_SUM_WINDOW; ++r) v[r] = r < n ? src[r] : 0.0f;
  float acc = 0.0f;
  RH_SC_UNROLL
  for (int r = 0; r < RH_SUM_WINDOW; ++r) acc = acc + (sq ? v[r] * v[r] : v[r]);
  return acc;
}

// Where value i of a level above the row sits in the levels' shared
// memory: a float of padding after each of its blocks (windows), so that
// the lanes of a warp, a block (window) each, read from distinct banks
// (block or window k from k (width + 1) - front; the function of the block
// above at src + k reads it).  width: 16 (prefix sum) or 32 (sum); front:
// the sum's front padding of the level (0 for a prefix sum and for the top
// level, which this leaves unpadded).
RH_SC_HD int rh_lev_at(int i, int width, int front) {
  return i + (i + front) / width;
}

// ---- level 0 in rounds of tiles -------------------------------------------

RH_SC_HD int rh_ct_slot(int q, int lane) {
  return (2 * q + (lane >> 4)) * RH_CT_STRIDE + (lane & 15);
}

RH_SC_HD int rh_st_at(int c, int r) {
  return c * RH_SUM_WINDOW + ((((r >> 2) ^ (c & 7)) << 2) | (r & 3));
}

RH_SC_HD int rh_st_slot(int q, int lane) { return rh_st_at(q, lane); }

// where lane's q-th 4 values of a round (values 128 q + 4 lane ..) go
RH_SC_HD int rh_st_slot4(int q, int lane) {
  return rh_st_at(4 * q + (lane >> 3), 4 * (lane & 7));
}

// Block c of a prefix tile: its total, and (sq) its squares' total.
RH_SC_HD void rh_ct_total(const float* tile, int c, bool sq, float* tot,
                          float* tot_sq) {
  const float* v = tile + c * RH_CT_STRIDE;
  float a = 0.0f, s = 0.0f;
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) {
    a = a + v[r];
    if (sq) s = s + v[r] * v[r];
  }
  *tot = a;
  *tot_sq = s;
}

// Block c of a prefix tile replaced by its running sums plus carry; (sq)
// its squares' running sums plus carry_sq into sq_tile.
RH_SC_HD void rh_ct_out(float* tile, float* sq_tile, int c, float carry,
                        float carry_sq) {
  float* v = tile + c * RH_CT_STRIDE;
  float a = 0.0f, s = 0.0f;
  for (int r = 0; r < RH_SCAN_BLOCK; ++r) {
    const float x = v[r];
    a = a + x;
    v[r] = a + carry;
    if (sq_tile) {
      s = s + x * x;
      sq_tile[c * RH_CT_STRIDE + r] = s + carry_sq;
    }
  }
}

// Window c of a sum tile: its total, and (sq) its squares' total, read 4
// values at a time (the tile 16-byte aligned).
RH_SC_HD void rh_st_total(const float* tile, int c, bool sq, float* tot,
                          float* tot_sq) {
  float a = 0.0f, s = 0.0f;
  for (int k = 0; k < RH_SUM_WINDOW / 4; ++k) {
    float v[4];
    const float* chunk = tile + rh_st_at(c, 4 * k);
#ifdef __CUDA_ARCH__
    const float4 f = *reinterpret_cast<const float4*>(chunk);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
#else
    for (int e = 0; e < 4; ++e) v[e] = chunk[e];
#endif
    for (int e = 0; e < 4; ++e) {
      a = a + v[e];
      if (sq) s = s + v[e] * v[e];
    }
  }
  *tot = a;
  *tot_sq = s;
}

// How a launch lays out a row of n values: G warps a row (1 up to 8192
// values, else 8), rows a block (4 at a warp a row, else 1), the tiles a
// warp stages at a time (res: all of its rounds, or as many as fit
// RH_SCAN_SMEM_BUDGET with the levels; fewer than its rounds, the rounds
// are copied again for the prefix sum's down-sweep), and the shared memory
// of a row and of a block.  0 if a block needs more than RH_SCAN_SMEM_MAX.
// The plan also carries the row's levels: their sizes, the sum's front
// paddings and each level's offset in the levels' shared memory (level 1
// at 0, each level padded as rh_lev_at places it), so that a kernel reads
// them from its parameters.
struct RhScanPlan {
  int g, rows, res, units, rounds, top;
  long long lev, row_floats, smem;
  int sizes[RH_SCAN_MAX_LEVELS], fronts[RH_SCAN_MAX_LEVELS],
      offs[RH_SCAN_MAX_LEVELS + 1];
};

RH_SC_HD int rh_scan_plan(int n, bool prefix, bool sq, RhScanPlan* p) {
  int* sizes = p->sizes;
  for (int j = 0; j < RH_SCAN_MAX_LEVELS; ++j) p->fronts[j] = 0;
  const int top = prefix ? rh_cumsum_levels(n, sizes)
                         : rh_sum_levels(n, sizes, p->fronts);
  p->top = top;
  p->offs[0] = p->offs[1] = 0;
  const int width = prefix ? RH_SCAN_BLOCK : RH_SUM_WINDOW;
  for (int j = 1; j < top; ++j)
    p->offs[j + 1] =
        p->offs[j] + rh_lev_at(sizes[j] - 1, width, p->fronts[j]) + 1;
  p->units = prefix ? (n + RH_SCAN_BLOCK - 1) / RH_SCAN_BLOCK
                    : (top ? sizes[1] : 0);
  p->rounds = (p->units + 31) / 32;
  p->g = n > 8192 ? 8 : 1;
  p->rows = p->g == 1 ? 4 : 1;
  p->lev = top ? p->offs[top] + sizes[top] : 0;
  const long long tile = prefix ? RH_CT_FLOATS : RH_ST_FLOATS;
  // the levels, then the tiles from a 16-byte boundary (and the prefix
  // sum's out tiles of the squares)
  const long long fixed = (((sq ? 2 : 1) * p->lev + 3) & ~3LL) +
                          (prefix && sq ? p->g * tile : 0);
  const int mine = (p->rounds + p->g - 1) / p->g;
  long long fit = (RH_SCAN_SMEM_BUDGET / 4 / p->rows - fixed) / (p->g * tile);
  if (fit < 1) fit = 1;
  p->res = mine < fit ? (mine < 1 ? 1 : mine) : (int)fit;
  p->row_floats = fixed + p->g * p->res * tile;
  p->smem = 4 * p->rows * p->row_floats;
  return p->smem <= RH_SCAN_SMEM_MAX;
}

// ---- the levels above the row by a team --------------------------------------
//
// A team is the threads that work one row together: tm.each(f) runs
// f(t, nt) on each of its nt members (t = 0 .. nt - 1), then waits for all
// of them (a CUDA block and __syncthreads; on the host, a loop).  The levels
// sit as the plan places them (level j at P.offs[j], each value at
// rh_lev_at), level 1 filled by the caller from the row.

// The sum's levels 2 .. top of L and (unless null) L2; the top level's sum
// is rh_sum_top(L + P.offs[P.top], P.sizes[P.top], false).
template <class Team>
RH_SC_TEAM void rh_sum_levels_team(Team& tm, float* L, float* L2,
                                   const RhScanPlan& P) {
  for (int j = 1; j < P.top; ++j)
    tm.each([&](int t, int nt) {
      for (int k = t; k < P.sizes[j + 1]; k += nt) {
        const int at =
            P.offs[j + 1] + rh_lev_at(k, RH_SUM_WINDOW, P.fronts[j + 1]);
        L[at] = rh_sum_window(L + P.offs[j] + k, P.sizes[j], P.fronts[j], k);
        if (L2)
          L2[at] = rh_sum_window(L2 + P.offs[j] + k, P.sizes[j], P.fronts[j], k);
      }
    });
}

// The prefix sum's levels of L and (unless null) L2 (P.top >= 1): the
// up-sweep, the top's scan, the down-sweep; level 1 then holds the
// inclusive prefix of the row's block totals.
template <class Team>
RH_SC_TEAM void rh_prefix_levels_team(Team& tm, float* L, float* L2,
                                      const RhScanPlan& P) {
  const int top = P.top;
  for (int j = 1; j < top; ++j)
    tm.each([&](int t, int nt) {
      for (int k = t; k < P.sizes[j + 1]; k += nt) {
        const int at = P.offs[j + 1] + rh_lev_at(k, RH_SCAN_BLOCK, 0);
        L[at] = rh_cumsum_block_total(L + P.offs[j] + k, P.sizes[j], k);
        if (L2)
          L2[at] = rh_cumsum_block_total(L2 + P.offs[j] + k, P.sizes[j], k);
      }
    });
  tm.each([&](int t, int nt) {
    if (t == 0) rh_cumsum_top(L + P.offs[top], P.sizes[top], L + P.offs[top]);
    if (L2 && t == nt - 1)
      rh_cumsum_top(L2 + P.offs[top], P.sizes[top], L2 + P.offs[top]);
  });
  for (int j = top - 1; j >= 1; --j)
    tm.each([&](int t, int nt) {
      for (int k = t; k < P.sizes[j + 1]; k += nt) {
        const int pre = P.offs[j + 1] + rh_lev_at(k - 1, RH_SCAN_BLOCK, 0);
        float* blk = L + P.offs[j] + k;
        rh_cumsum_block_out(blk, P.sizes[j], k, k ? L[pre] : 0.0f, blk);
        if (L2) {
          float* blk2 = L2 + P.offs[j] + k;
          rh_cumsum_block_out(blk2, P.sizes[j], k, k ? L2[pre] : 0.0f, blk2);
        }
      }
    });
}
