// Native (host-spine) KNN evaluator: cluster-pruned exact search + IVF.
//
// The reference's KNN walks one KDTree per query on one CPU
// (models/KNeighbors checkpoint, loaded at traffic_classifier.py:234-236);
// the framework's XLA paths (models/knn.py) rank by an f32 dot-expansion
// similarity on device. This evaluator is the accelerator-less host
// entrant: exact float64 squared distances with the lax.top_k total
// order ((distance asc, corpus index asc) — ties to the earlier index),
// votes as class counts over the k nearest with first-maximum argmax,
// mirroring models/knn.neighbor_votes → argmax.
//
// PRUNED exact engine (tck_predict / tck_votes — the default). At build
// time the corpus is coarse-clustered (a fixed-seed Lloyd pass in here —
// deterministic: fixed init, fixed iteration count, fixed summation
// order), lists are laid out consecutively and split into uniform
// kEChunk-wide chunks (sentinel-padded), each anchored on the rounded
// f32 mean of its REAL members. Queries run in 8-wide blocks:
//
//   1. exact f64 squared distances to every chunk anchor;
//   2. each query seeds its running top-k exactly from its nearest
//      chunk (blocked f64 refine — FMA latency hidden across members);
//   3. one sweep over the remaining chunks: per (query, chunk), an
//      Elkan-style triangle screen in squared space
//      (‖x−t‖ ≥ ‖x−ã‖ − cmax and, inside the hull,
//      ‖x−t‖ ≥ cmin − ‖x−ã‖ for every member t of the chunk) skips
//      the whole chunk for that query without touching a member;
//      chunks that survive for ANY query in the block pay ONE
//      f-streamed f32 distance screen shared across the block's
//      surviving queries — the same vectorization shape as the
//      unpruned kernel, restricted to the (query, chunk) pairs the
//      triangle bound cannot clear. A member whose f32 distance
//      exceeds the query's bound inflated by kScreenMargin32 is
//      screened out; the few survivors pay the exact f64 accumulation
//      (ascending-f — bitwise-identical addend order to the unpruned
//      path) with a per-feature early-abandon against the LIVE k-th
//      best distance.
//
// Every pruning step is provably lossless. The f32 screen consumes the
// SAME f32 inputs the f64 path widens, so its 12-term accumulation is
// within ~2e-6 relative of the exact sum — a 1e-5 threshold margin
// makes a screened candidate's f64 distance strictly above the
// incumbent worst, ties included. The triangle tests compare against a
// bound radius inflated by the deflation reserve (1e-9 ≫ the f64
// sqrt/sub/mul rounding); the early-abandon is exact (a partial sum of
// nonnegative addends only grows, and only STRICTLY-greater partials
// abandon). Candidate order is scan-order-independent: insertion
// compares (distance, corpus index) lexicographically, so any visiting
// order produces the exact ascending-index-scan top-k. The anchor of
// every triangle bound is the ROUNDED chunk mean — a concrete point,
// so the inequality is exact regardless of how it was derived.
// Non-finite queries (and corpora with non-finite values, where
// cluster geometry is meaningless) fall back to the ascending full
// scan — parity with the unpruned path holds on every input. Cluster
// QUALITY only affects speed, never results. Measured on this class of
// flow corpora the exact pruned tier gains ~1.2-1.8× over the blocked
// full scan at k=5 (docs/artifacts/knn_prune_cpu.json records the
// same-run A/B); the order-of-magnitude rescue lives in the IVF tier
// below and the XLA screened path (models/knn.py).
//
// UNPRUNED baseline (tck_predict_unpruned / tck_votes_unpruned): the
// original GEMM-style blocked evaluator — 8-query blocks × 256-row
// corpus chunks, per-feature streaming accumulation that autovectorizes
// without -ffast-math. Kept callable so tools/bench_knn.py can race
// pruned vs unpruned in ONE process on identical inputs
// (docs/artifacts/knn_prune_cpu.json) and the parity suite can pin
// vote-for-vote equality.
//
// IVF tier (tck_ivf_build + tck_predict_ivf / tck_votes_ivf): the
// approximate tier behind the explicit `--knn-topk ivf` opt-in. The
// coarse quantizer (KMeans centers + assignments) is fit in Python by
// the already-device-resident kernel (train/kmeans.py via
// ops/knn_ivf.py) and handed over; queries rank the centroids exactly
// (f64 over the same rounded centers, (distance, centroid index)
// order), probe only the nprobe nearest lists, and run the bounded
// exact member scan within them. nprobe >= K degenerates to the exact
// search bit-for-bit (every list scanned; candidate order is
// comparator-defined, not scan-defined) — the anchor
// tests/test_knn_ivf.py pins. tck_ivf_build is NOT thread-safe against
// in-flight predicts (build once, then serve — the same discipline as
// tck_create).
//
// Screen accounting: per-handle atomic totals (candidates screened out
// by the triangle/f32 bounds, early-abandoned partial distances,
// queries) read by tck_screen_stats — the serving layer surfaces them
// as the knn_candidates_screened / knn_candidates_abandoned counters.
//
// Plain C ABI for ctypes (no pybind11 in this image) — same pattern as
// flow_engine.cpp / forest_eval.cpp.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr uint32_t kQueryBlock = 8;
constexpr uint32_t kChunk = 256;
// Exact-tier chunk width: small enough that whole-chunk triangle skips
// fire (radius shrinks with the chunk), large enough to amortize the
// shared screen's loop constants.
constexpr uint32_t kEChunk = 32;
constexpr uint32_t kMaxK = 64;
constexpr uint32_t kMaxIvfLists = 65536;
constexpr uint32_t kLloydIters = 8;
// Deflation absorbing the f64 rounding of the sqrt/sub/mul bound chain
// (relative error ≤ ~1e-13) so a triangle bound can never reject a
// candidate whose computed distance would have been inserted.
constexpr double kScreenDeflate = 1.0 - 1e-9;
// Threshold inflation for the f32 SIMD distance screen: a 12-term f32
// accumulation of the SAME f32 inputs the f64 path widens differs from
// the exact sum by ≤ ~(F+2)·2⁻²⁴ ≈ 2e-6 relative, so a candidate whose
// f32 distance exceeds bound×(1+1e-5) provably has f64 distance
// strictly above the bound — it could never be inserted, ties included.
constexpr double kScreenMargin32 = 1.0 + 1e-5;
// Sentinel member index padding each list-aligned chunk to the uniform
// width: sentinel columns hold kSentinelVal, so every screen and exact
// distance sees +inf-scale values and rejects them — they can never
// enter a top-k (S >= k real members always exist).
constexpr uint32_t kSentinel = 0xffffffffu;
constexpr double kSentinelVal = 1e300;

// The exact tier's index: the corpus permuted into spatial locality
// order (a fixed-seed Lloyd pass — lists laid out consecutively), then
// cut into UNIFORM kChunk-member chunks aligned with the streaming
// layout. Each chunk carries its own anchor (the ROUNDED f32 mean of
// its members — a concrete point, so the triangle bound anchored on it
// is exact no matter how it was derived) and the min/max member-anchor
// distances the whole-chunk skip tests compare against.
struct Chunks {
    uint32_t nchunk = 0;
    uint32_t spad = 0;              // padded member count (NC * kEChunk)
    std::vector<uint32_t> nreal;    // (NC,) real members per chunk
    std::vector<double> anch_cols;  // (F, NC) column-major, f64 of the
                                    // rounded f32 anchors
    std::vector<double> cmin;       // (NC,) min member-anchor distance
    std::vector<double> cmax;       // (NC,) max member-anchor distance
    std::vector<uint32_t> orig;     // (S,) original corpus idx, scan order
    std::vector<float> cols32;      // (F, S) f32 columns, scan order —
                                    // the SIMD screen's operand (the
                                    // corpus IS f32 input: lossless)
    std::vector<double> cols64;     // (F, S) f64 columns, scan order —
                                    // the blocked exact refine operand
};

// The IVF tier's index: list-contiguous permuted corpus + per-list
// geometry, installed from the Python-fit quantizer (centers rounded
// to f32 anchors, mirrored to f64 for the probe ranking).
struct Coarse {
    uint32_t K = 0;
    uint32_t max_list = 0;          // longest list (scratch sizing)
    std::vector<double> cent_cols;  // (F, K) column-major, f64 mirror
    std::vector<uint32_t> off;      // (K+1,) list offsets
    std::vector<double> cmin;       // (K,) min member-anchor distance
    std::vector<double> cmax;       // (K,) max member-anchor distance
    std::vector<uint32_t> orig;     // (S,) original corpus idx, scan order
    std::vector<double> cols64;     // (F, S) f64 columns, scan order —
                                    // the blocked probe-refine operand
};

struct Knn {
    uint32_t S, F, C, k;
    std::vector<double> cols;  // (F, S) column-major corpus (unpruned)
    std::vector<double> rows;  // (S, F) row-major corpus (scalar scans)
    std::vector<int32_t> y;    // (S,)
    bool prunable = false;     // finite corpus → cluster geometry valid
    Chunks exact;              // built at tck_create
    Coarse ivf;                // built at tck_ivf_build (K==0 until then)
    // screen accounting (relaxed: counters, not synchronization)
    std::atomic<uint64_t> screened{0};
    std::atomic<uint64_t> abandoned{0};
    std::atomic<uint64_t> queries{0};
};

struct Cand {
    double d;
    uint32_t idx;
};

// (distance asc, corpus index asc) — the lax.top_k total order, as an
// explicit comparator so candidate insertion is independent of scan
// order (the cluster scans rely on this; the ascending-scan unpruned
// path produces the same order by construction).
inline bool cand_better(double d, uint32_t idx, const Cand &w) {
    return d < w.d || (d == w.d && idx < w.idx);
}

inline double b_worst(const Cand *b, uint32_t k) { return b[k - 1].d; }

inline void push_cand(Cand *b, uint32_t &n, uint32_t k, double d,
                      uint32_t idx) {
    if (n == k && !cand_better(d, idx, b[k - 1])) return;
    uint32_t pos = (n < k) ? n : k - 1;
    while (pos > 0 && cand_better(d, idx, b[pos - 1])) {
        b[pos] = b[pos - 1];
        --pos;
    }
    b[pos] = Cand{d, idx};
    if (n < k) ++n;
}

inline void stage_query(const Knn *h, const float *X, uint64_t q,
                        uint32_t F, double *xq, double *qsq) {
    double s = 0.0;
    for (uint32_t f = 0; f < h->F; ++f) {
        xq[f] = double(X[q * F + f]);
        s += xq[f] * xq[f];
    }
    *qsq = s;
}

// Exact f64 member scan over a permuted-column range [m0, m1): the
// ascending-f accumulation (bitwise-identical addend order to the
// unpruned path) with the per-feature early abandon against the LIVE
// k-th best distance. The workhorse of the seed lists, the n<k phase,
// and every screen survivor.
inline void refine_range(const Knn *h, const uint32_t *orig,
                         const double *xq, uint32_t m0, uint32_t m1,
                         Cand *b, uint32_t &n, uint64_t *aband) {
    const uint32_t F = h->F, k = h->k;
    for (uint32_t m = m0; m < m1; ++m) {
        // row-major access: one member = one contiguous 96-byte row
        // (the column layout would cost a cache line PER FEATURE here)
        const uint32_t si = orig[m];
        const double *row = h->rows.data() + size_t(si) * F;
        double d = 0.0;
        bool dead = false;
        for (uint32_t f = 0; f < F; ++f) {
            const double diff = xq[f] - row[f];
            d += diff * diff;
            if (n == k && d > b[k - 1].d && f + 1 < F) {
                dead = true;  // early abandon: nonneg addends only grow
                break;        // the partial sum
            }
        }
        if (dead) {
            ++*aband;
            continue;
        }
        push_cand(b, n, k, d, si);
    }
}

// One screen survivor's exact distance — the scalar ascending-f chain
// with the per-feature early abandon against the LIVE bound.
inline void refine_member(const Knn *h, const Chunks &C,
                          const double *xq, uint32_t m, Cand *b,
                          uint32_t &n, uint64_t *aband) {
    refine_range(h, C.orig.data(), xq, m, m + 1, b, n, aband);
}

// Exact f64 distances for a WHOLE chunk, f-streamed over the
// list-contiguous f64 columns — elementwise ascending-f accumulation,
// so every sum is bitwise-identical to the scalar chain (and to the
// unpruned path), with the FMA latency hidden across the chunk's
// members. Used by the seed chunks and the still-filling phase.
inline void refine_chunk_blocked(const Knn *h, const Chunks &C,
                                 const double *xq, uint32_t c, Cand *b,
                                 uint32_t &n, double *accd) {
    const uint32_t F = h->F, k = h->k, SP = C.spad;
    const uint32_t m0 = c * kEChunk;
    const uint32_t L = kEChunk;
    std::memset(accd, 0, L * sizeof(double));
    for (uint32_t f = 0; f < F; ++f) {
        const double x = xq[f];
        const double *col = C.cols64.data() + size_t(f) * SP + m0;
        for (uint32_t j = 0; j < L; ++j) {
            const double diff = x - col[j];
            accd[j] += diff * diff;
        }
    }
    for (uint32_t j = 0; j < L; ++j)
        if (C.orig[m0 + j] != kSentinel)
            push_cand(b, n, k, accd[j], C.orig[m0 + j]);
}

// Ascending full scan, no pruning — the fallback for non-finite
// queries / non-prunable corpora, and the exactness reference the
// comparator-ordered scans must (and do) reproduce.
void knn_topk_full(const Knn *h, const double *xq, Cand *b, uint32_t &n) {
    const uint32_t F = h->F, S = h->S, k = h->k;
    for (uint32_t i = 0; i < S; ++i) {
        double d = 0.0;
        for (uint32_t f = 0; f < F; ++f) {
            const double d0 = xq[f] - h->rows[size_t(i) * F + f];
            d += d0 * d0;
        }
        push_cand(b, n, k, d, i);
    }
}

// Per-call scratch (allocated once per C call, shared across that
// call's query blocks; each call owns its own — no cross-thread state,
// so concurrent predicts stay race-free).
struct Scratch {
    std::vector<double> ad2;     // (QB, NC) f64 anchor distances
    std::vector<double> accd;    // (kChunk,) blocked-refine sums
    std::vector<float> acc32;    // (QB, kChunk) f32 screen distances
    std::vector<double> cd2;     // (K,) f64 anchor distances (IVF)
    std::vector<uint32_t> cord;  // (K,) probe order (IVF)
    Scratch(uint32_t nchunk, uint32_t K_ivf, uint32_t ivf_maxlist = 0)
        : ad2(size_t(kQueryBlock) * (nchunk ? nchunk : 1)),
          accd(std::max(kEChunk, ivf_maxlist ? ivf_maxlist : 1)),
          acc32(size_t(kQueryBlock) * kEChunk),
          cd2(K_ivf ? K_ivf : 1), cord(K_ivf ? K_ivf : 1) {}
};

inline void votes_from_best(const Knn *h, const Cand *b, uint32_t n,
                            uint32_t *v) {
    const uint32_t C = h->C;
    std::memset(v, 0, C * sizeof(uint32_t));
    for (uint32_t j = 0; j < n; ++j) {
        const int32_t lab = h->y[b[j].idx];
        if (lab >= 0 && uint32_t(lab) < C) ++v[lab];
    }
}

inline int32_t argmax_votes(const uint32_t *v, uint32_t C) {
    uint32_t argc = 0, bv = v[0];
    for (uint32_t c = 1; c < C; ++c)
        if (v[c] > bv) { bv = v[c]; argc = c; }  // first max wins
    return int32_t(argc);
}

// The 8-query blocked pruned exact engine (see the file header for the
// stages and the losslessness argument). votes: (QB, C).
void knn_votes_block(const Knn *h, const float *X, uint64_t q0,
                     uint32_t QB, uint32_t F, uint32_t *votes,
                     Scratch &s, uint64_t *scr, uint64_t *aband) {
    const Chunks &C = h->exact;
    const uint32_t NC = C.nchunk, k = h->k, SP = C.spad, Fh = h->F;
    double xq[kQueryBlock][32];
    float xf[kQueryBlock][32];
    Cand best[kQueryBlock][kMaxK];
    uint32_t n[kQueryBlock];
    bool blk[kQueryBlock];  // query runs through the block engine
    uint32_t nblk = 0;
    for (uint32_t q = 0; q < QB; ++q) {
        n[q] = 0;
        double qsq;
        stage_query(h, X, q0 + q, F, xq[q], &qsq);
        for (uint32_t f = 0; f < Fh; ++f)
            xf[q][f] = X[(q0 + q) * F + f];
        blk[q] = h->prunable && std::isfinite(qsq);
        if (blk[q]) {
            ++nblk;
        } else {
            knn_topk_full(h, xq[q], best[q], n[q]);
        }
    }
    if (nblk) {
        // --- stage 1: exact f64 anchor distances (NC is small) ----------
        double *ad2 = s.ad2.data();
        for (uint32_t q = 0; q < QB; ++q) {
            if (!blk[q]) continue;
            double *a = ad2 + size_t(q) * NC;
            std::memset(a, 0, NC * sizeof(double));
            for (uint32_t f = 0; f < Fh; ++f) {
                const double x = xq[q][f];
                const double *ac = C.anch_cols.data() + size_t(f) * NC;
                for (uint32_t c = 0; c < NC; ++c) {
                    const double diff = x - ac[c];
                    a[c] += diff * diff;
                }
            }
        }
        // --- stage 2: seed each query from its nearest chunk ------------
        uint32_t seed[kQueryBlock];
        for (uint32_t q = 0; q < QB; ++q) {
            if (!blk[q]) continue;
            const double *a = ad2 + size_t(q) * NC;
            uint32_t c0 = 0;
            for (uint32_t c = 1; c < NC; ++c)
                if (a[c] < a[c0]) c0 = c;
            seed[q] = c0;
            refine_chunk_blocked(h, C, xq[q], c0, best[q], n[q],
                                 s.accd.data());
        }
        // --- stage 3: one sweep, shared f32 screen ----------------------
        double sb[kQueryBlock], sb_at[kQueryBlock];
        for (uint32_t q = 0; q < QB; ++q) {
            sb[q] = 0.0;
            sb_at[q] = -1.0;  // cache invalid
        }
        uint32_t needs[kQueryBlock];
        for (uint32_t c = 0; c < NC; ++c) {
            const uint32_t m0 = c * kEChunk;
            const uint32_t L = kEChunk;
            const uint32_t nreal = C.nreal[c];
            uint32_t nneed = 0, nscreen = 0;
            for (uint32_t q = 0; q < QB; ++q) {
                if (!blk[q] || c == seed[q]) continue;
                if (n[q] == k) {
                    const double worst = b_worst(best[q], k);
                    if (worst != sb_at[q]) {
                        // inflate the radius so |dist| > sb implies
                        // dist²·deflate > bound even after fp rounding
                        sb_at[q] = worst;
                        sb[q] = std::sqrt(worst / kScreenDeflate);
                    }
                    const double cmin = C.cmin[c], cmax = C.cmax[c];
                    const double hi_edge = cmax + sb[q];
                    const double d2 = ad2[size_t(q) * NC + c];
                    if (d2 > hi_edge * hi_edge
                        || (cmin > sb[q]
                            && d2 < (cmin - sb[q]) * (cmin - sb[q]))) {
                        *scr += nreal;  // whole chunk provably rejected
                        continue;
                    }
                    ++nscreen;
                }
                needs[nneed++] = q;
            }
            if (!nneed) continue;
            // shared f32 screen for the bound-holding queries (skipped
            // for still-filling queries — they refine every member)
            if (nscreen) {
                float *acc = s.acc32.data();
                for (uint32_t t = 0; t < nneed; ++t)
                    if (n[needs[t]] == k)
                        std::memset(acc + size_t(needs[t]) * kEChunk, 0,
                                    L * sizeof(float));
                for (uint32_t f = 0; f < Fh; ++f) {
                    const float *col =
                        C.cols32.data() + size_t(f) * SP + m0;
                    for (uint32_t t = 0; t < nneed; ++t) {
                        const uint32_t q = needs[t];
                        if (n[q] != k) continue;
                        const float x = xf[q][f];
                        float *a = acc + size_t(q) * kEChunk;
                        for (uint32_t j = 0; j < L; ++j) {
                            const float diff = x - col[j];
                            a[j] += diff * diff;
                        }
                    }
                }
            }
            for (uint32_t t = 0; t < nneed; ++t) {
                const uint32_t q = needs[t];
                if (n[q] != k) {  // still filling: exact, no screen
                    refine_chunk_blocked(h, C, xq[q], c, best[q], n[q],
                                         s.accd.data());
                    continue;
                }
                const float *a = s.acc32.data() + size_t(q) * kEChunk;
                const float thr =
                    float(b_worst(best[q], k) * kScreenMargin32);
                float mn = a[0];  // vectorizable min-reduce: most
                for (uint32_t j = 1; j < L; ++j)  // chunks have no
                    mn = std::min(mn, a[j]);      // survivor at all
                if (mn > thr) {
                    *scr += nreal;
                    continue;
                }
                uint32_t kept = 0;
                for (uint32_t j = 0; j < L; ++j) {
                    if (a[j] > thr) continue;  // rare, predictable
                    ++kept;
                    refine_member(h, C, xq[q], m0 + j, best[q], n[q],
                                  aband);
                }
                *scr += nreal - kept;
            }
        }
    }
    for (uint32_t q = 0; q < QB; ++q)
        votes_from_best(h, best[q], n[q], votes + size_t(q) * h->C);
}


// IVF probe: one query's votes over its nprobe nearest lists. Centroid
// ranking is exact f64 over the rounded anchors with (distance,
// centroid index) order; members pay the triangle screen + exact
// refine. nprobe >= K is the exact search (comparator order, every
// list scanned once — the corpus is a partition of the lists).
void knn_votes_ivf_one(const Knn *h, const float *X, uint64_t q,
                       uint32_t F, uint32_t nprobe, uint32_t *v,
                       Scratch &s, uint64_t *scr, uint64_t *aband) {
    (void)aband;  // the blocked probe refine has no scalar abandon
    const Coarse &C = h->ivf;
    const uint32_t K = C.K, k = h->k, Fh = h->F;
    double xq[32];
    double qsq;
    stage_query(h, X, q, F, xq, &qsq);
    Cand best[kMaxK];
    uint32_t n = 0;
    if (!h->prunable || !std::isfinite(qsq)) {
        // geometry is meaningless — serve the exact full scan (a
        // superset of any probe set, so still deterministic)
        knn_topk_full(h, xq, best, n);
        votes_from_best(h, best, n, v);
        return;
    }
    double *cd2 = s.cd2.data();
    std::memset(cd2, 0, K * sizeof(double));
    for (uint32_t f = 0; f < Fh; ++f) {
        const double x = xq[f];
        const double *cc = C.cent_cols.data() + size_t(f) * K;
        for (uint32_t c = 0; c < K; ++c) {
            const double diff = x - cc[c];
            cd2[c] += diff * diff;
        }
    }
    uint32_t *cord = s.cord.data();
    std::iota(cord, cord + K, 0u);
    const uint32_t visit = nprobe < K ? nprobe : K;
    std::partial_sort(
        cord, cord + visit, cord + K, [&](uint32_t a, uint32_t bb) {
            return cd2[a] < cd2[bb] || (cd2[a] == cd2[bb] && a < bb);
        });
    double sb = 0.0, sb_at = -1.0;
    for (uint32_t i = 0; i < visit; ++i) {
        const uint32_t c = cord[i];
        const uint32_t m0 = C.off[c], m1 = C.off[c + 1];
        if (m0 == m1) continue;
        if (n == k) {
            if (best[k - 1].d != sb_at) {
                sb_at = best[k - 1].d;
                sb = std::sqrt(sb_at / kScreenDeflate);
            }
            const double cmin = C.cmin[c], cmax = C.cmax[c];
            const double hi_edge = cmax + sb;
            if (cd2[c] > hi_edge * hi_edge
                || (cmin > sb && cd2[c] < (cmin - sb) * (cmin - sb))) {
                *scr += m1 - m0;
                continue;
            }
        }
        // blocked exact refine of the probed list: f-streamed f64
        // accumulation (elementwise ascending-f — bitwise-identical to
        // the scalar chain), FMA latency hidden across members
        double *accd = s.accd.data();
        const uint32_t L = m1 - m0;
        std::memset(accd, 0, L * sizeof(double));
        for (uint32_t f = 0; f < Fh; ++f) {
            const double x = xq[f];
            const double *col = C.cols64.data() + size_t(f) * h->S + m0;
            for (uint32_t j = 0; j < L; ++j) {
                const double diff = x - col[j];
                accd[j] += diff * diff;
            }
        }
        for (uint32_t j = 0; j < L; ++j)
            push_cand(best, n, k, accd[j], C.orig[m0 + j]);
    }
    votes_from_best(h, best, n, v);
}

// Populate a Coarse index from centroids (f64 (K, F) row-major, rounded
// to the f32 anchors in here) and per-point assignments. Lists are
// contiguous, members in ascending original-index order — a
// deterministic layout the result order never depends on (the candidate
// comparator owns tie order).
void build_coarse(const Knn *h, Coarse &C, uint32_t K,
                  const std::vector<double> &centers,
                  const std::vector<uint32_t> &assign) {
    const uint32_t S = h->S, F = h->F;
    C.K = K;
    C.cent_cols.assign(size_t(F) * K, 0.0);
    for (uint32_t c = 0; c < K; ++c)
        for (uint32_t f = 0; f < F; ++f)
            C.cent_cols[size_t(f) * K + c] =
                double(float(centers[size_t(c) * F + f]));
    C.off.assign(K + 1, 0);
    for (uint32_t s = 0; s < S; ++s) ++C.off[assign[s] + 1];
    for (uint32_t c = 0; c < K; ++c) C.off[c + 1] += C.off[c];
    C.orig.resize(S);
    std::vector<uint32_t> cursor(C.off.begin(), C.off.end() - 1);
    for (uint32_t s = 0; s < S; ++s)  // ascending s → ascending per list
        C.orig[cursor[assign[s]]++] = s;
    C.cmin.assign(K, 0.0);
    C.cmax.assign(K, 0.0);
    C.cols64.resize(size_t(F) * S);
    C.max_list = 0;
    for (uint32_t c = 0; c < K; ++c) {
        C.max_list = std::max(C.max_list, C.off[c + 1] - C.off[c]);
        for (uint32_t m = C.off[c]; m < C.off[c + 1]; ++m) {
            const uint32_t s = C.orig[m];
            double sq = 0.0;
            for (uint32_t f = 0; f < F; ++f) {
                const double v = h->rows[size_t(s) * F + f];
                C.cols64[size_t(f) * S + m] = v;
                // member-anchor distances measure to the ROUNDED
                // centroid — the point the triangle bounds anchor on
                const double diff = v - C.cent_cols[size_t(f) * K + c];
                sq += diff * diff;
            }
            const double d = std::sqrt(sq);
            if (m == C.off[c] || d < C.cmin[c]) C.cmin[c] = d;
            if (m == C.off[c] || d > C.cmax[c]) C.cmax[c] = d;
        }
    }
}

// Fixed-seed Lloyd clustering for the exact tier's internal index:
// deterministic (spread init over the corpus order, kLloydIters
// iterations, fixed summation order). Quality only affects pruning
// power, never results.
void build_exact_index(Knn *h) {
    const uint32_t S = h->S, F = h->F;
    uint32_t K = S / 16;  // small lists: strong whole-list skips, cheap
                          // shared screens (tuned on the bench corpus)
    if (K < 1) K = 1;
    if (K > S) K = S;
    std::vector<double> centers(size_t(K) * F);
    for (uint32_t c = 0; c < K; ++c) {
        const uint32_t s = uint32_t((uint64_t(c) * S) / K);
        for (uint32_t f = 0; f < F; ++f)
            centers[size_t(c) * F + f] = h->rows[size_t(s) * F + f];
    }
    std::vector<uint32_t> assign(S, 0);
    std::vector<double> sums(size_t(K) * F);
    std::vector<uint32_t> counts(K);
    for (uint32_t it = 0; it < kLloydIters; ++it) {
        for (uint32_t s = 0; s < S; ++s) {
            const double *row = h->rows.data() + size_t(s) * F;
            double bd = 0.0;
            uint32_t bc = 0;
            for (uint32_t c = 0; c < K; ++c) {
                double d = 0.0;
                const double *ce = centers.data() + size_t(c) * F;
                for (uint32_t f = 0; f < F; ++f) {
                    const double diff = row[f] - ce[f];
                    d += diff * diff;
                }
                if (c == 0 || d < bd) { bd = d; bc = c; }
            }
            assign[s] = bc;
        }
        std::fill(sums.begin(), sums.end(), 0.0);
        std::fill(counts.begin(), counts.end(), 0u);
        for (uint32_t s = 0; s < S; ++s) {
            double *acc = sums.data() + size_t(assign[s]) * F;
            const double *row = h->rows.data() + size_t(s) * F;
            for (uint32_t f = 0; f < F; ++f) acc[f] += row[f];
            ++counts[assign[s]];
        }
        for (uint32_t c = 0; c < K; ++c)
            if (counts[c])  // empty cluster: keep the previous center
                for (uint32_t f = 0; f < F; ++f)
                    centers[size_t(c) * F + f] =
                        sums[size_t(c) * F + f] / double(counts[c]);
    }
    // lay the corpus out in cluster order, each list split into
    // kEChunk-wide chunks padded with sentinel members (kSentinelVal
    // columns — rejected by every screen and every exact compare), so
    // chunk geometry is LIST geometry: tight anchors, firing skips
    std::vector<uint32_t> off(K + 1, 0);
    for (uint32_t s = 0; s < S; ++s) ++off[assign[s] + 1];
    for (uint32_t c = 0; c < K; ++c) off[c + 1] += off[c];
    std::vector<uint32_t> order(S);
    {
        std::vector<uint32_t> cursor(off.begin(), off.end() - 1);
        for (uint32_t s = 0; s < S; ++s)
            order[cursor[assign[s]]++] = s;
    }
    uint32_t NC = 0;
    for (uint32_t c = 0; c < K; ++c)
        NC += (off[c + 1] - off[c] + kEChunk - 1) / kEChunk;
    Chunks &C = h->exact;
    C.nchunk = NC;
    C.spad = NC * kEChunk;
    C.orig.assign(C.spad, kSentinel);
    C.nreal.assign(NC, 0);
    C.cols32.assign(size_t(F) * C.spad, float(kSentinelVal));
    C.cols64.assign(size_t(F) * C.spad, kSentinelVal);
    C.anch_cols.assign(size_t(F) * NC, 0.0);
    C.cmin.assign(NC, 0.0);
    C.cmax.assign(NC, 0.0);
    std::vector<double> mean(F);
    uint32_t chunk = 0;
    for (uint32_t c = 0; c < K; ++c) {
        for (uint32_t base = off[c]; base < off[c + 1];
             base += kEChunk, ++chunk) {
            const uint32_t nreal =
                std::min(kEChunk, off[c + 1] - base);
            C.nreal[chunk] = nreal;
            const uint32_t m0 = chunk * kEChunk;
            std::fill(mean.begin(), mean.end(), 0.0);
            for (uint32_t j = 0; j < nreal; ++j) {
                const uint32_t s = order[base + j];
                C.orig[m0 + j] = s;
                for (uint32_t f = 0; f < F; ++f) {
                    const double v = h->rows[size_t(s) * F + f];
                    C.cols64[size_t(f) * C.spad + m0 + j] = v;
                    C.cols32[size_t(f) * C.spad + m0 + j] = float(v);
                    mean[f] += v;
                }
            }
            // anchor: the rounded f32 mean of the REAL members — a
            // concrete point, so the triangle bound is exact
            for (uint32_t f = 0; f < F; ++f)
                C.anch_cols[size_t(f) * NC + chunk] =
                    double(float(mean[f] / double(nreal)));
            for (uint32_t j = 0; j < nreal; ++j) {
                double sq = 0.0;
                for (uint32_t f = 0; f < F; ++f) {
                    const double diff =
                        C.cols64[size_t(f) * C.spad + m0 + j]
                        - C.anch_cols[size_t(f) * NC + chunk];
                    sq += diff * diff;
                }
                const double d = std::sqrt(sq);
                if (j == 0 || d < C.cmin[chunk]) C.cmin[chunk] = d;
                if (j == 0 || d > C.cmax[chunk]) C.cmax[chunk] = d;
            }
        }
    }
}

// ---- unpruned baseline (the original blocked evaluator) -------------------

// One query block's k-nearest vote counts — 8-query blocks × 256-row
// corpus chunks, per-feature streaming accumulation (prefetch-friendly;
// a register-blocked 12-stream variant measured 3× SLOWER here).
// Elementwise, no cross-lane reduction — vectorizes exactly without
// -ffast-math, f-order fixed per element. Candidate fold: ascending
// corpus index; a candidate EQUAL to the incumbent worst is rejected,
// so earlier indices win ties — the lax.top_k total order.
void knn_votes_range_unpruned(const Knn *h, const float *X, uint64_t q0,
                              uint32_t QB, uint32_t F, uint32_t *votes) {
    const uint32_t S = h->S, C = h->C, k = h->k;
    double acc[kQueryBlock][kChunk];
    double xq[kQueryBlock][32];
    Cand best[kQueryBlock][kMaxK];
    uint32_t nbest[kQueryBlock];
    for (uint32_t q = 0; q < QB; ++q) nbest[q] = 0;
    for (uint32_t q = 0; q < QB; ++q)
        for (uint32_t f = 0; f < h->F; ++f)
            xq[q][f] = double(X[(q0 + q) * F + f]);
    for (uint32_t c0 = 0; c0 < S; c0 += kChunk) {
        const uint32_t CH = (S - c0 < kChunk) ? (S - c0) : kChunk;
        for (uint32_t q = 0; q < QB; ++q)
            std::memset(acc[q], 0, CH * sizeof(double));
        for (uint32_t f = 0; f < h->F; ++f) {
            const double *col = h->cols.data() + size_t(f) * S + c0;
            for (uint32_t q = 0; q < QB; ++q) {
                const double x = xq[q][f];
                double *a = acc[q];
                for (uint32_t i = 0; i < CH; ++i) {
                    const double diff = x - col[i];
                    a[i] += diff * diff;
                }
            }
        }
        for (uint32_t q = 0; q < QB; ++q) {
            Cand *b = best[q];
            uint32_t n = nbest[q];
            const double *a = acc[q];
            for (uint32_t i = 0; i < CH; ++i) {
                const double d = a[i];
                if (n == k && !(d < b[k - 1].d)) continue;
                uint32_t pos = (n < k) ? n : k - 1;
                while (pos > 0 && b[pos - 1].d > d) {
                    b[pos] = b[pos - 1];
                    --pos;
                }
                b[pos] = Cand{d, c0 + i};
                if (n < k) nbest[q] = ++n;
            }
        }
    }
    for (uint32_t q = 0; q < QB; ++q)
        votes_from_best(h, best[q], k, votes + size_t(q) * C);
}

}  // namespace

extern "C" {

void *tck_create(uint32_t S, uint32_t F, uint32_t C, uint32_t k,
                 const float *fit_X, const int32_t *fit_y) {
    if (S == 0 || F == 0 || F > 32 || C == 0 || k == 0 || k > kMaxK
        || S < k)
        return nullptr;  // F cap matches the query staging buffer
    Knn *h = new Knn();
    h->S = S;
    h->F = F;
    h->C = C;
    h->k = k;
    h->cols.resize(size_t(F) * S);
    h->rows.resize(size_t(S) * F);
    bool finite = true;
    for (uint32_t s = 0; s < S; ++s) {
        for (uint32_t f = 0; f < F; ++f) {
            const double v = double(fit_X[size_t(s) * F + f]);
            h->cols[size_t(f) * S + s] = v;
            h->rows[size_t(s) * F + f] = v;
            if (!std::isfinite(v)) finite = false;
        }
    }
    h->y.assign(fit_y, fit_y + S);
    // cluster geometry (and the triangle bounds built on it) is only
    // meaningful over a finite corpus; otherwise every query takes the
    // ascending full-scan fallback
    h->prunable = finite;
    if (h->prunable) build_exact_index(h);
    return h;
}

void tck_destroy(void *h) { delete static_cast<Knn *>(h); }

// X: (N, F) float32 row-major; out: (N,) int32 class indices — the
// PRUNED exact path (vote-for-vote identical to tck_predict_unpruned).
void tck_predict(void *hp, const float *X, uint64_t N, uint32_t F,
                 int32_t *out) {
    Knn *h = static_cast<Knn *>(hp);
    const uint32_t C = h->C;
    std::vector<uint32_t> votes(size_t(kQueryBlock) * C);
    Scratch s(h->exact.nchunk, 0);
    uint64_t scr = 0, aband = 0;
    for (uint64_t q0 = 0; q0 < N; q0 += kQueryBlock) {
        const uint32_t QB =
            uint32_t(N - q0 < kQueryBlock ? N - q0 : kQueryBlock);
        knn_votes_block(h, X, q0, QB, F, votes.data(), s, &scr, &aband);
        for (uint32_t q = 0; q < QB; ++q)
            out[q0 + q] = argmax_votes(votes.data() + size_t(q) * C, C);
    }
    h->screened.fetch_add(scr, std::memory_order_relaxed);
    h->abandoned.fetch_add(aband, std::memory_order_relaxed);
    h->queries.fetch_add(N, std::memory_order_relaxed);
}

// X: (N, F) float32 row-major; out: (N, C) int32 neighbor vote counts
// — the score surface (argmax with first-max ties == tck_predict).
void tck_votes(void *hp, const float *X, uint64_t N, uint32_t F,
               int32_t *out) {
    Knn *h = static_cast<Knn *>(hp);
    const uint32_t C = h->C;
    std::vector<uint32_t> votes(size_t(kQueryBlock) * C);
    Scratch s(h->exact.nchunk, 0);
    uint64_t scr = 0, aband = 0;
    for (uint64_t q0 = 0; q0 < N; q0 += kQueryBlock) {
        const uint32_t QB =
            uint32_t(N - q0 < kQueryBlock ? N - q0 : kQueryBlock);
        knn_votes_block(h, X, q0, QB, F, votes.data(), s, &scr, &aband);
        for (uint32_t q = 0; q < QB; ++q)
            for (uint32_t c = 0; c < C; ++c)
                out[(q0 + q) * C + c] =
                    int32_t(votes[size_t(q) * C + c]);
    }
    h->screened.fetch_add(scr, std::memory_order_relaxed);
    h->abandoned.fetch_add(aband, std::memory_order_relaxed);
    h->queries.fetch_add(N, std::memory_order_relaxed);
}

// The original blocked full-scan evaluator — the same-run A/B baseline
// (docs/artifacts/knn_prune_cpu.json) and the parity oracle.
void tck_predict_unpruned(void *hp, const float *X, uint64_t N,
                          uint32_t F, int32_t *out) {
    const Knn *h = static_cast<const Knn *>(hp);
    const uint32_t C = h->C;
    std::vector<uint32_t> votes(size_t(kQueryBlock) * C);
    for (uint64_t q0 = 0; q0 < N; q0 += kQueryBlock) {
        const uint32_t QB =
            uint32_t(N - q0 < kQueryBlock ? N - q0 : kQueryBlock);
        knn_votes_range_unpruned(h, X, q0, QB, F, votes.data());
        for (uint32_t q = 0; q < QB; ++q)
            out[q0 + q] = argmax_votes(votes.data() + size_t(q) * C, C);
    }
}

void tck_votes_unpruned(void *hp, const float *X, uint64_t N, uint32_t F,
                        int32_t *out) {
    const Knn *h = static_cast<const Knn *>(hp);
    const uint32_t C = h->C;
    std::vector<uint32_t> votes(size_t(kQueryBlock) * C);
    for (uint64_t q0 = 0; q0 < N; q0 += kQueryBlock) {
        const uint32_t QB =
            uint32_t(N - q0 < kQueryBlock ? N - q0 : kQueryBlock);
        knn_votes_range_unpruned(h, X, q0, QB, F, votes.data());
        for (uint32_t q = 0; q < QB; ++q)
            for (uint32_t c = 0; c < C; ++c)
                out[(q0 + q) * C + c] =
                    int32_t(votes[size_t(q) * C + c]);
    }
}

// Install the IVF coarse index: centers (K, F) float32 row-major,
// assign (S,) int32 in [0, K). Returns 0 on success. NOT thread-safe
// against concurrent predicts — build before serving.
int32_t tck_ivf_build(void *hp, uint32_t K, const float *centers,
                      const int32_t *assign) {
    Knn *h = static_cast<Knn *>(hp);
    if (K == 0 || K > kMaxIvfLists) return 1;
    for (uint32_t s = 0; s < h->S; ++s)
        if (assign[s] < 0 || uint32_t(assign[s]) >= K) return 2;
    std::vector<double> cents(size_t(K) * h->F);
    for (size_t i = 0; i < cents.size(); ++i)
        cents[i] = double(centers[i]);
    std::vector<uint32_t> a(h->S);
    for (uint32_t s = 0; s < h->S; ++s) a[s] = uint32_t(assign[s]);
    build_coarse(h, h->ivf, K, cents, a);
    return 0;
}

// IVF predict/votes: nprobe nearest lists only (clamped to K). Returns
// without writing when no index is built — callers gate on
// tck_ivf_build's 0 return.
void tck_predict_ivf(void *hp, const float *X, uint64_t N, uint32_t F,
                     uint32_t nprobe, int32_t *out) {
    Knn *h = static_cast<Knn *>(hp);
    if (h->ivf.K == 0 || nprobe == 0) return;
    const uint32_t C = h->C;
    std::vector<uint32_t> v(C);
    Scratch s(0, h->ivf.K, h->ivf.max_list);
    uint64_t scr = 0, aband = 0;
    for (uint64_t q = 0; q < N; ++q) {
        knn_votes_ivf_one(h, X, q, F, nprobe, v.data(), s, &scr,
                          &aband);
        out[q] = argmax_votes(v.data(), C);
    }
    h->screened.fetch_add(scr, std::memory_order_relaxed);
    h->abandoned.fetch_add(aband, std::memory_order_relaxed);
    h->queries.fetch_add(N, std::memory_order_relaxed);
}

void tck_votes_ivf(void *hp, const float *X, uint64_t N, uint32_t F,
                   uint32_t nprobe, int32_t *out) {
    Knn *h = static_cast<Knn *>(hp);
    if (h->ivf.K == 0 || nprobe == 0) return;
    const uint32_t C = h->C;
    std::vector<uint32_t> v(C);
    Scratch s(0, h->ivf.K, h->ivf.max_list);
    uint64_t scr = 0, aband = 0;
    for (uint64_t q = 0; q < N; ++q) {
        knn_votes_ivf_one(h, X, q, F, nprobe, v.data(), s, &scr,
                          &aband);
        for (uint32_t c = 0; c < C; ++c)
            out[q * C + c] = int32_t(v[c]);
    }
    h->screened.fetch_add(scr, std::memory_order_relaxed);
    h->abandoned.fetch_add(aband, std::memory_order_relaxed);
    h->queries.fetch_add(N, std::memory_order_relaxed);
}

// Cumulative screen accounting: out[0]=screened (triangle/f32-bound
// skips), out[1]=abandoned (partial-distance early exits),
// out[2]=queries.
void tck_screen_stats(void *hp, uint64_t *out) {
    const Knn *h = static_cast<const Knn *>(hp);
    out[0] = h->screened.load(std::memory_order_relaxed);
    out[1] = h->abandoned.load(std::memory_order_relaxed);
    out[2] = h->queries.load(std::memory_order_relaxed);
}

}  // extern "C"
