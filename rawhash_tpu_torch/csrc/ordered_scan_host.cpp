// The ordered sums of ordered_scan.cuh on the host (built with g++ by
// _build.py::load_host_library), as the kernels run them: a row's G warps
// one after another, each warp's lanes as a loop, level 0 in rounds of
// tiles staged `res` at a time in the tile layout the kernels use (G and
// res as the kernels' plan gives them), the levels above on the first warp.  The tests hold
// them against the plain versions.
//
// rh_prefix_host: x f32 rows of n values (row r at x + r * stride); out
// (and out_sq, or null) rows at out + r * ostride of lead + n values: a
// leading 0 if lead, then the prefix sums of the row (of its squares).
// rh_sum_host: the row sums into out[b] and, unless null, the sums of the
// squares into out_sq[b].  Both return 0, or -1 where the kernel would
// refuse the row (too long).  rh_scan_plan_host: the kernels' plan of a row
// of n values (warps a row, rows a block, tiles staged at a time, rounds a
// row, shared memory a block) into out[5]; returns 0 where the kernel would
// refuse the row.
#include <stddef.h>

#include <vector>

#include "ordered_scan.cuh"

namespace {

// as the kernels' stage(): rounds t0 .. t0 + cnt - 1 of warp w into tiles
void stage(const float* xr, int n, int front, float* tiles, int t0, int cnt,
           int w, int g, bool prefix) {
  const int tile_floats = prefix ? RH_CT_FLOATS : RH_ST_FLOATS;
  const int values = prefix ? RH_CT_VALUES : RH_ST_VALUES;
  for (int t = 0; t < cnt; ++t) {
    const int base = values * ((t0 + t) * g + w) - front;
    float* tile = tiles + t * tile_floats;
    for (int q = 0; q < values / 32; ++q)
      for (int lane = 0; lane < 32; ++lane) {
        const int i = base + 32 * q + lane;
        tile[prefix ? rh_ct_slot(q, lane) : rh_st_slot(q, lane)] =
            i >= 0 && i < n ? xr[i] : 0.0f;
      }
  }
}

}  // namespace

extern "C" int rh_prefix_host(const float* x, long long stride, float* out,
                              float* out_sq, long long ostride, int lead, int b,
                              int n) {
  if (b <= 0 || n <= 0) return 0;
  const bool sq = out_sq != nullptr;
  RhScanPlan P;
  if (!rh_scan_plan(n, true, sq, &P)) return -1;
  const int top = P.top;
  const int *sizes = P.sizes, *offs = P.offs;
  std::vector<float> lev(P.lev + 1), lev_sq(P.lev + 1);
  std::vector<float> tiles((size_t)P.res * RH_CT_FLOATS), sq_tile(RH_CT_FLOATS);
  for (int row = 0; row < b; ++row) {
    const float* xr = x + row * stride;
    float* o = out + row * ostride + lead;
    float* osq = sq ? out_sq + row * ostride + lead : nullptr;
    // up-sweep, warp by warp
    for (int w = 0; w < P.g; ++w) {
      const int mine = w < P.rounds ? (P.rounds - 1 - w) / P.g + 1 : 0;
      for (int t0 = 0; t0 < mine; t0 += P.res) {
        const int cnt = P.res < mine - t0 ? P.res : mine - t0;
        stage(xr, n, 0, tiles.data(), t0, cnt, w, P.g, true);
        for (int t = 0; t < cnt; ++t)
          for (int lane = 0; lane < 32; ++lane) {
            const int k = 32 * ((t0 + t) * P.g + w) + lane;
            float a, s;
            rh_ct_total(tiles.data() + t * RH_CT_FLOATS, lane, sq, &a, &s);
            if (top && k < P.units) {
              lev[rh_lev_at(k, RH_SCAN_BLOCK, 0)] = a;
              lev_sq[rh_lev_at(k, RH_SCAN_BLOCK, 0)] = s;
            }
          }
      }
    }
    // the levels above
    for (int pass = 0; pass < (sq ? 2 : 1) && top; ++pass) {
      float* L = pass ? lev_sq.data() : lev.data();
      for (int j = 1; j < top; ++j)
        for (int k = 0; k < sizes[j + 1]; ++k)
          L[offs[j + 1] + rh_lev_at(k, RH_SCAN_BLOCK, 0)] =
              rh_cumsum_block_total(L + offs[j] + k, sizes[j], k);
      rh_cumsum_top(L + offs[top], sizes[top], L + offs[top]);
      for (int j = top - 1; j >= 1; --j)
        for (int k = 0; k < sizes[j + 1]; ++k)
          rh_cumsum_block_out(
              L + offs[j] + k, sizes[j], k,
              k ? L[offs[j + 1] + rh_lev_at(k - 1, RH_SCAN_BLOCK, 0)] : 0.0f,
              L + offs[j] + k);
    }
    // down-sweep, warp by warp, each segment staged again
    if (lead) {
      o[-1] = 0.0f;
      if (sq) osq[-1] = 0.0f;
    }
    for (int w = 0; w < P.g; ++w) {
      const int mine = w < P.rounds ? (P.rounds - 1 - w) / P.g + 1 : 0;
      for (int t0 = 0; t0 < mine; t0 += P.res) {
        const int cnt = P.res < mine - t0 ? P.res : mine - t0;
        stage(xr, n, 0, tiles.data(), t0, cnt, w, P.g, true);
        for (int t = 0; t < cnt; ++t) {
          const int u = (t0 + t) * P.g + w;
          float* tile = tiles.data() + t * RH_CT_FLOATS;
          for (int lane = 0; lane < 32; ++lane) {
            const int k = 32 * u + lane;
            if (k >= P.units) continue;
            const int pre = rh_lev_at(k - 1, RH_SCAN_BLOCK, 0);
            rh_ct_out(tile, sq ? sq_tile.data() : nullptr, lane,
                      k ? lev[pre] : 0.0f, sq && k ? lev_sq[pre] : 0.0f);
          }
          for (int q = 0; q < RH_SCAN_BLOCK; ++q)
            for (int lane = 0; lane < 32; ++lane) {
              const int i = RH_CT_VALUES * u + 32 * q + lane;
              if (i < n) {
                o[i] = tile[rh_ct_slot(q, lane)];
                if (sq) osq[i] = sq_tile[rh_ct_slot(q, lane)];
              }
            }
        }
      }
    }
  }
  return 0;
}

extern "C" int rh_sum_host(const float* x, long long stride, float* out,
                           float* out_sq, int b, int n) {
  if (b <= 0) return 0;
  const bool sq = out_sq != nullptr;
  RhScanPlan P;
  if (!rh_scan_plan(n, false, sq, &P)) return -1;
  const int top = P.top;
  const int *sizes = P.sizes, *fronts = P.fronts, *offs = P.offs;
  std::vector<float> lev(P.lev + 1), lev_sq(P.lev + 1);
  std::vector<float> tiles((size_t)P.res * RH_ST_FLOATS);
  for (int row = 0; row < b; ++row) {
    const float* xr = x + row * stride;
    if (!top) {
      out[row] = rh_sum_top(xr, n, false);
      if (sq) out_sq[row] = rh_sum_top(xr, n, true);
      continue;
    }
    for (int w = 0; w < P.g; ++w) {
      const int mine = w < P.rounds ? (P.rounds - 1 - w) / P.g + 1 : 0;
      for (int t0 = 0; t0 < mine; t0 += P.res) {
        const int cnt = P.res < mine - t0 ? P.res : mine - t0;
        stage(xr, n, fronts[0], tiles.data(), t0, cnt, w, P.g, false);
        for (int t = 0; t < cnt; ++t)
          for (int lane = 0; lane < 32; ++lane) {
            const int k = 32 * ((t0 + t) * P.g + w) + lane;
            float a, s;
            rh_st_total(tiles.data() + t * RH_ST_FLOATS, lane, sq, &a, &s);
            if (k < P.units) {
              lev[rh_lev_at(k, RH_SUM_WINDOW, fronts[1])] = a;
              lev_sq[rh_lev_at(k, RH_SUM_WINDOW, fronts[1])] = s;
            }
          }
      }
    }
    for (int pass = 0; pass < (sq ? 2 : 1); ++pass) {
      float* L = pass ? lev_sq.data() : lev.data();
      for (int j = 1; j < top; ++j)
        for (int k = 0; k < sizes[j + 1]; ++k)
          L[offs[j + 1] + rh_lev_at(k, RH_SUM_WINDOW, fronts[j + 1])] =
              rh_sum_window(L + offs[j] + k, sizes[j], fronts[j], k);
      (pass ? out_sq : out)[row] = rh_sum_top(L + offs[top], sizes[top], false);
    }
  }
  return 0;
}

extern "C" int rh_scan_plan_host(int n, int prefix, int sq, long long* out) {
  RhScanPlan P;
  const int ok = rh_scan_plan(n, prefix != 0, sq != 0, &P);
  out[0] = P.g, out[1] = P.rows, out[2] = P.res, out[3] = P.rounds,
  out[4] = P.smem;
  return ok;
}
