// Native index-build hot path: sequence -> seeds, and the global seed sort.
//
// Bit-exact replacement for the numpy build pipeline
// (pore.py::seq_to_sig + sketch/host.py::sketch_events_np +
//  index/build.py::_finalize's lexsort), which is the reference's
// multithreaded 3-step index pipeline (reference: rindex.c:921 worker
// pipeline, rindex.c:463-491 parallel bucket finalize) re-hosted as a
// single-pass native kernel + a bucketed parallel sort.  All float math is
// strict float32 (compiled with -ffp-contract=off) so quantization codes
// match the numpy oracle bit-for-bit.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// reference: hash64 masked to 32 bits (src/rsketch.c:7-16)
inline uint32_t hash32(uint32_t key) {
    key = ~key + (key << 21);
    key = key ^ (key >> 24);
    key = (key + (key << 3)) + (key << 8);
    key = key ^ (key >> 14);
    key = (key + (key << 2)) + (key << 4);
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

// reference: ri_quantize (src/rsketch.c:18-53); numerics identical to
// sketch/quantize.py::dynamic_quantize_np (strict float32)
inline int32_t quantize(float sig, float fine_min, float fine_max,
                        float fine_range, float coarse1, float coarse2,
                        float a, float b, float scale_buckets) {
    const float min_val = -3.0f;
    const float rng = 6.0f;
    float normalized = (sig - min_val) / rng;
    float quantized;
    if (sig >= fine_min && sig <= fine_max) {
        quantized = fine_range * ((normalized - a) / (b - a));
    } else if (normalized < 0.5f) {
        quantized = fine_range + coarse1 * normalized;
    } else {
        quantized = coarse2 + coarse1 * normalized;
    }
    float scaled = quantized * scale_buckets;
    return (int32_t)(int64_t)std::trunc(scaled);
}

uint8_t NT4[256];
struct Nt4Init {
    Nt4Init() {
        std::memset(NT4, 4, sizeof(NT4));
        NT4[(int)'A'] = NT4[(int)'a'] = 0;
        NT4[(int)'C'] = NT4[(int)'c'] = 1;
        NT4[(int)'G'] = NT4[(int)'g'] = 2;
        NT4[(int)'T'] = NT4[(int)'t'] = 3;
    }
} nt4_init;

}  // namespace

extern "C" {

// Sketch one (sequence, strand) into seeds.
//   seq: ASCII bases, length n.  strand 1 walks the reverse complement
//   (reference: ri_seq_to_sig, rsig.c:13-40).
//   sig_out (optional, may be null): the n-k+1 expected signal values
//   (--store-sig).  hashes_out/ys_out: capacity n-k+1.
// Returns the number of seeds emitted.
int64_t rh_sketch_seq(
    const uint8_t* seq, int64_t n,
    const float* pore_vals, int32_t k, int32_t strand, uint32_t sid,
    double diff_d, int32_t w, int32_t e, int32_t q,
    double fine_min_d, double fine_max_d, double fine_range_d,
    int64_t pos_offset,
    float* sig_out, uint32_t* hashes_out, uint64_t* ys_out) {
    if (n < k) return 0;
    const int64_t m = n - k + 1;
    const float diff = (float)diff_d;
    const float fine_min = (float)fine_min_d;
    const float fine_max = (float)fine_max_d;
    const float fine_range = (float)fine_range_d;
    // float32 constants exactly as the numpy path builds them:
    //   coarse1 = f32((1.0 - fine_range)/2.0)   [double math, one cast]
    //   coarse2 = f32(fine_range) + coarse1     [f32 add]
    //   a = (f32(fine_min) - (-3)) / 6, b likewise
    const float coarse1 = (float)((1.0 - fine_range_d) / 2.0);
    const float coarse2 = fine_range + coarse1;
    const float qa = (fine_min - (-3.0f)) / 6.0f;
    const float qb = (fine_max - (-3.0f)) / 6.0f;
    const int n_buckets = 1 << q;
    const float scale_buckets = (float)(n_buckets - 1);
    const int32_t code_mask = n_buckets - 1;
    const uint64_t pack_mask =
        (q * e < 64) ? ((1ull << (q * e)) - 1) : ~0ull;

    // rolling state
    uint64_t kmer = 0;
    const uint64_t kmask = (1ull << (2 * k)) - 1;
    float last_kept = 0.0f;
    bool any_kept = false;
    uint64_t packed = 0;
    int64_t kept_cnt = 0;  // events kept by the diff filter
    std::vector<int64_t> ring((size_t)e);  // positions of last e kept events
    int64_t n_seeds = 0;

    // minimizer buffers (w > 0): emit after collecting the full stream
    std::vector<uint32_t> mh;
    std::vector<int64_t> mp;
    if (w > 0) {
        mh.reserve((size_t)m);
        mp.reserve((size_t)m);
    }

    for (int64_t j = 0; j < n; ++j) {
        uint8_t c = strand ? NT4[seq[n - 1 - j]] : NT4[seq[j]];
        if (strand && c < 4) c ^= 3;
        if (c < 4) kmer = ((kmer << 2) | c) & kmask;
        if (j < k - 1) continue;
        const int64_t i = j - (k - 1);  // event position
        const float v = pore_vals[kmer];
        if (sig_out) sig_out[i] = v;
        // event-diff filter (reference: rsketch.c:95,187)
        if (any_kept && std::fabs(v - last_kept) < diff) continue;
        last_kept = v;
        any_kept = true;
        const int32_t code =
            quantize(v, fine_min, fine_max, fine_range, coarse1, coarse2,
                     qa, qb, scale_buckets) &
            code_mask;
        packed = ((packed << q) | (uint32_t)code) & pack_mask;
        ring[(size_t)(kept_cnt % e)] = i;
        ++kept_cnt;
        if (kept_cnt < e) continue;
        const uint32_t h = hash32((uint32_t)packed);
        const int64_t first_pos = ring[(size_t)(kept_cnt % e)];
        if (w > 0) {
            mh.push_back(h);
            mp.push_back(first_pos);
        } else {
            hashes_out[n_seeds] = h;
            ys_out[n_seeds] = ((uint64_t)sid << 32) |
                              ((uint64_t)(first_pos + pos_offset) << 1) |
                              (uint64_t)(strand ? 1 : 0);
            ++n_seeds;
        }
    }

    if (w > 0 && !mh.empty()) {
        const int64_t ms = (int64_t)mh.size();
        std::vector<uint8_t> mask((size_t)ms, 0);
        if (ms < w) {
            // incomplete window: rightmost minimum only
            uint32_t mn = mh[0];
            for (int64_t t = 1; t < ms; ++t) mn = std::min(mn, mh[(size_t)t]);
            for (int64_t t = ms - 1; t >= 0; --t)
                if (mh[(size_t)t] == mn) {
                    mask[(size_t)t] = 1;
                    break;
                }
        } else {
            // window minima; seed kept iff equal to the minimum of a window
            // containing it (reference: ri_sketch_min emission set,
            // rsketch.c:55-141)
            const int64_t nw = ms - w + 1;
            std::vector<uint32_t> wmin((size_t)nw);
            // sliding-window minimum via monotonic deque
            std::vector<int64_t> dq((size_t)ms);
            int64_t qh = 0, qt = 0;
            for (int64_t t = 0; t < ms; ++t) {
                while (qt > qh && mh[(size_t)dq[(size_t)(qt - 1)]] >= mh[(size_t)t])
                    --qt;
                dq[(size_t)(qt++)] = t;
                if (dq[(size_t)qh] <= t - w) ++qh;
                if (t >= w - 1) wmin[(size_t)(t - w + 1)] = mh[(size_t)dq[(size_t)qh]];
            }
            for (int64_t t = 0; t < ms; ++t) {
                const int64_t s_lo = std::max<int64_t>(0, t - w + 1);
                const int64_t s_hi = std::min<int64_t>(nw - 1, t);
                for (int64_t s = s_lo; s <= s_hi; ++s)
                    if (mh[(size_t)t] == wmin[(size_t)s]) {
                        mask[(size_t)t] = 1;
                        break;
                    }
            }
        }
        for (int64_t t = 0; t < ms; ++t) {
            if (!mask[(size_t)t]) continue;
            hashes_out[n_seeds] = mh[(size_t)t];
            ys_out[n_seeds] = ((uint64_t)sid << 32) |
                              ((uint64_t)(mp[(size_t)t] + pos_offset) << 1) |
                              (uint64_t)(strand ? 1 : 0);
            ++n_seeds;
        }
    }
    return n_seeds;
}

// Sort seeds by (hash, y): MSD bucket on the top 8 hash bits, then
// per-bucket comparison sorts across n_threads workers (the reference's
// per-bucket parallel finalize, rindex.c:463-491; (hash, y) pairs are
// unique, so any comparison sort reproduces numpy's lexsort order).
void rh_sort_seeds(uint32_t* hashes, uint64_t* ys, int64_t n,
                   int32_t n_threads) {
    if (n <= 1) return;
    struct Rec {
        uint64_t y;
        uint32_t h;
    };
    std::vector<Rec> recs((size_t)n);
    int64_t bucket_count[256] = {0};
    for (int64_t i = 0; i < n; ++i) ++bucket_count[hashes[i] >> 24];
    int64_t bucket_off[257];
    bucket_off[0] = 0;
    for (int i = 0; i < 256; ++i)
        bucket_off[i + 1] = bucket_off[i] + bucket_count[i];
    {
        int64_t cur[256];
        std::memcpy(cur, bucket_off, sizeof(cur));
        for (int64_t i = 0; i < n; ++i) {
            const int b = hashes[i] >> 24;
            recs[(size_t)cur[b]++] = Rec{ys[i], hashes[i]};
        }
    }
    const int nt = std::max(1, (int)n_threads);
    std::vector<std::thread> workers;
    std::atomic<int> next_bucket{0};
    auto work = [&]() {
        for (;;) {
            const int b = next_bucket.fetch_add(1);
            if (b >= 256) return;
            Rec* lo = recs.data() + bucket_off[b];
            Rec* hi = recs.data() + bucket_off[b + 1];
            std::sort(lo, hi, [](const Rec& x, const Rec& y) {
                return x.h != y.h ? x.h < y.h : x.y < y.y;
            });
        }
    };
    for (int t = 1; t < nt; ++t) workers.emplace_back(work);
    work();
    for (auto& th : workers) th.join();
    for (int64_t i = 0; i < n; ++i) {
        hashes[i] = recs[(size_t)i].h;
        ys[i] = recs[(size_t)i].y;
    }
}

}  // extern "C"
