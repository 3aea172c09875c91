// Native (host-spine) random-forest evaluator.
//
// The reference's ENTIRE production compute path is a per-flow CPU predict
// through sklearn's Cython Tree.predict (traffic_classifier.py:103-106);
// this is the TPU framework's host-side equivalent for deployments where
// no accelerator is attached (and the honest CPU entrant the fallback
// bench races against that exact sklearn path). One core, cache-tight,
// and structured around the walk being LATENCY-bound, not FLOP-bound:
//
//   - nodes repacked per tree into 8-byte DFS-preorder records (float
//     threshold, uint16 feature, uint16 right; the left child is
//     implicitly node+1) — the whole 100-tree forest is ~80 KB, near-L1-
//     resident, and the common left-descent walks forward through memory;
//   - leaves become SELF-LOOPS (thr = NaN, right = self) at load time
//     and stepping is an arithmetic select (no cmov-vs-branch codegen
//     gamble): the only branch in the walk is the group exit, taken once
//     per group when all WIDE rows have stabilized at their leaves —
//     the group's true max depth (~8 empirically), not the worst case;
//   - rows walk in blocks of 256, WIDE rows interleaved in registers
//     inside each tree: WIDE independent load chains in flight per
//     iteration, hiding the ~L1-latency per step (the Cython path walks
//     one row at a time through every tree, serializing on each chain).
//     Measured on the 1-core bench host: 774k rows/s vs sklearn's 367k
//     (same forest, same host) — interleave width swept 4/8/12/16/24,
//     WIDE=8 won;
//   - leaf class distributions are the caller's float64 values
//     (values/sum computed in numpy), accumulated in tree order per row —
//     bitwise the same sums as the numpy level-synchronous oracle in
//     bench._numpy_forest_labels, so argmax parity is exact, not
//     approximate. Argmax takes the FIRST maximum (strict >), matching
//     np.argmax tie semantics.
//
// Plain C ABI for ctypes (no pybind11 in this image) — same pattern as
// flow_engine.cpp.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// 8-byte node in DFS-preorder layout: the left child is implicitly
// node+1 (preorder, left first), so only the right index is stored —
// half the bytes per node, and the common left-descent walks FORWARD
// through memory (cacheline + prefetcher friendly). Leaves carry
// thr = NaN (the `x <= thr` test is false for every x, including -inf
// and NaN) and right = self, forming the self-loop the group exit
// detects.
struct Node {
    float thr;
    uint16_t feat;
    uint16_t right;
};
static_assert(sizeof(Node) == 8, "walk layout relies on 8-byte nodes");

struct Forest {
    uint32_t n_trees;
    uint32_t stride;    // padded nodes per tree
    uint32_t n_classes;
    std::vector<Node> nodes;       // (T * stride), DFS-preorder per tree
    std::vector<double> leaf;      // (T * stride * C) normalized dists
};

constexpr uint32_t kBlock = 256;

// interleave width: independent walk chains in flight per group (tuned
// empirically on the 1-core bench host; see tools note in forest.py)
#ifndef WIDE
#define WIDE 8
#endif


}  // namespace

extern "C" {

void *tcf_create(uint32_t n_trees, uint32_t stride, uint32_t n_classes,
                 const int32_t *feature, const float *threshold,
                 const int32_t *left, const int32_t *right,
                 const double *leaf_dist) {
    if (n_trees == 0 || stride == 0 || n_classes == 0 || stride > 65535)
        return nullptr;
    Forest *f = new Forest();
    f->n_trees = n_trees;
    f->stride = stride;
    f->n_classes = n_classes;
    f->nodes.resize(size_t(n_trees) * stride);
    f->leaf.assign(leaf_dist,
                   leaf_dist + size_t(n_trees) * stride * n_classes);
    std::vector<uint16_t> remap(stride);
    std::vector<int32_t> dfs;
    for (uint32_t t = 0; t < n_trees; ++t) {
        const size_t off = size_t(t) * stride;
        // DFS preorder (left first): the left child lands at parent+1 in
        // the new numbering; unreachable padded slots are never visited
        // (their node/leaf slots simply stay unused)
        dfs.assign(1, 0);
        uint32_t next_id = 0;
        while (!dfs.empty()) {
            const int32_t m = dfs.back();
            dfs.pop_back();
            remap[m] = uint16_t(next_id++);
            if (left[off + m] != -1) {
                dfs.push_back(right[off + m]);  // right visited after the
                dfs.push_back(left[off + m]);   // whole left subtree
            }
        }
        // second pass: write nodes/leaf dists at their new ids
        dfs.assign(1, 0);
        while (!dfs.empty()) {
            const int32_t m = dfs.back();
            dfs.pop_back();
            const uint16_t nid = remap[m];
            Node &n = f->nodes[off + nid];
            if (left[off + m] == -1) {
                // leaf sentinel: x <= NaN is false for EVERY x — finite,
                // -inf, or NaN — so the select always takes 'right',
                // the self-loop (a -inf threshold would break for
                // x == -inf and march the walk off the node array)
                n.thr = std::numeric_limits<float>::quiet_NaN();
                n.feat = 0;
                n.right = nid;      // self-loop
            } else {
                n.thr = threshold[off + m];
                n.feat = uint16_t(feature[off + m]);
                n.right = remap[right[off + m]];
                dfs.push_back(right[off + m]);
                dfs.push_back(left[off + m]);
            }
            std::memcpy(f->leaf.data() + (off + nid) * n_classes,
                        leaf_dist + (off + m) * n_classes,
                        n_classes * sizeof(double));
        }
    }
    return f;
}

void tcf_destroy(void *h) { delete static_cast<Forest *>(h); }

// X: (N, F) float32 row-major; out: (N,) int32 class indices.
void tcf_predict(void *h, const float *X, uint64_t N, uint32_t F,
                 int32_t *out) {
    const Forest *f = static_cast<const Forest *>(h);
    const uint32_t C = f->n_classes;
    const uint32_t T = f->n_trees;
    const uint32_t S = f->stride;
    std::vector<double> acc(size_t(kBlock) * C);
    std::vector<uint16_t> leaf_idx(kBlock);
    for (uint64_t r0 = 0; r0 < N; r0 += kBlock) {
        const uint32_t B = uint32_t(N - r0 < kBlock ? N - r0 : kBlock);
        std::memset(acc.data(), 0, size_t(B) * C * sizeof(double));
        const float *Xb = X + r0 * F;
        for (uint32_t t = 0; t < T; ++t) {
            const Node *tree = f->nodes.data() + size_t(t) * S;
            uint32_t r = 0;
            for (; r + WIDE <= B; r += WIDE) {
                // branch-free stepping (arithmetic select — no cmov-vs-
                // branch codegen gamble), eight independent chains in
                // flight; the ONLY branch is the group exit, not-taken
                // until all eight rows stabilize at their leaf self-loops
                // (the group's true max depth — empirically ~8 of the
                // worst-case 14 on the reference forest). The fixed-size
                // arrays fully unroll into registers at -O3.
                const float *xp[WIDE];
                uint32_t n[WIDE];
                for (uint32_t i = 0; i < WIDE; ++i) {
                    xp[i] = Xb + size_t(r + i) * F;
                    n[i] = 0;
                }
                for (;;) {
                    uint32_t same = 1;
#pragma GCC unroll 16
                    for (uint32_t i = 0; i < WIDE; ++i) {
                        const Node &A = tree[n[i]];
                        const uint32_t m =
                            -uint32_t(xp[i][A.feat] <= A.thr);
                        const uint32_t q =
                            ((n[i] + 1) & m) | (A.right & ~m);
                        same &= uint32_t(q == n[i]);
                        n[i] = q;
                    }
                    if (same) break;
                }
                for (uint32_t i = 0; i < WIDE; ++i)
                    leaf_idx[r + i] = uint16_t(n[i]);
            }
            for (; r < B; ++r) {
                const float *x = Xb + size_t(r) * F;
                uint32_t n = 0;
                for (;;) {
                    const Node &nd_ = tree[n];
                    const uint32_t m = -uint32_t(x[nd_.feat] <= nd_.thr);
                    const uint32_t q = ((n + 1) & m) | (nd_.right & ~m);
                    if (q == n) break;
                    n = q;
                }
                leaf_idx[r] = uint16_t(n);
            }
            // accumulate this tree's leaf distributions (tree order ==
            // the numpy oracle's addition order, float64: bitwise-equal)
            const double *ld = f->leaf.data() + size_t(t) * S * C;
            for (uint32_t rr = 0; rr < B; ++rr) {
                const double *dd = ld + size_t(leaf_idx[rr]) * C;
                double *a = acc.data() + size_t(rr) * C;
                for (uint32_t c = 0; c < C; ++c) a[c] += dd[c];
            }
        }
        for (uint32_t r = 0; r < B; ++r) {
            const double *a = acc.data() + size_t(r) * C;
            uint32_t best = 0;
            double bv = a[0];
            for (uint32_t c = 1; c < C; ++c)
                if (a[c] > bv) { bv = a[c]; best = c; }  // first max wins
            out[r0 + r] = int32_t(best);
        }
    }
}

// Mean class distribution per row (the predict_proba analogue), mostly
// for tests: probs (N, C) float64.
void tcf_proba(void *h, const float *X, uint64_t N, uint32_t F,
               double *probs) {
    const Forest *f = static_cast<const Forest *>(h);
    const uint32_t C = f->n_classes;
    const uint32_t T = f->n_trees;
    const uint32_t S = f->stride;
    std::memset(probs, 0, size_t(N) * C * sizeof(double));
    for (uint64_t r = 0; r < N; ++r) {
        const float *x = X + r * F;
        double *a = probs + r * C;
        for (uint32_t t = 0; t < T; ++t) {
            const Node *tree = f->nodes.data() + size_t(t) * S;
            uint32_t n = 0;
            for (;;) {
                const Node &nd = tree[n];
                const uint32_t m = -uint32_t(x[nd.feat] <= nd.thr);
                const uint32_t q = ((n + 1) & m) | (nd.right & ~m);
                if (q == n) break;
                n = q;
            }
            const double *dd = f->leaf.data() + (size_t(t) * S + n) * C;
            for (uint32_t c = 0; c < C; ++c) a[c] += dd[c];
        }
        for (uint32_t c = 0; c < C; ++c) a[c] /= T;
    }
}

}  // extern "C"
