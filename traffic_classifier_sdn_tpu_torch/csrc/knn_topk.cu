// Brute-force k-nearest-neighbor top-k on Hopper (sm_90a): one thread per
// query row computes its similarity to every corpus row and keeps a running
// top-k list, so the (N, S) similarity matrix never exists in memory.
//
// Replaces: traffic_classifier_sdn_tpu/ops/pallas_knn.py topk_sim_idx /
//   _kernel (the fused distance + running top-k TPU kernel). It computes
//   the same ((N, k) similarities, (N, k) indices): sim = x.s - 0.5|s|^2,
//   the k largest by (value desc, index asc), which is lax.top_k's order.
//   The TPU form (an MXU dot per 512 x 512 tile, k max-and-mask passes, a
//   rank-based carry merge across grid steps) exists for the MXU and the
//   sequential grid and is not carried over.
//
// What bounds it on the card: the arithmetic. Per (row, corpus row) pair
//   it does F multiplies, F - 1 adds, one subtract and one compare, while
//   a row moves 48 bytes in and 8k bytes out. The reference corpus (4448
//   rows x 64 bytes) stays in L2 and every block streams it through
//   shared memory. The products and sums are rounded one by one
//   (__fmul_rn / __fadd_rn, no fused multiply-add), so the kernel issues
//   2F instructions per pair where the card's float32 peak counts an FMA
//   as two operations: it cannot pass half of that peak.
//
// What the design does about it: corpus records are staged 256 at a time
//   in shared memory, where every thread of a block reads the same record
//   at once (a broadcast, four 16-byte loads per record). The query row and
//   the top-k list live in registers, and a candidate costs one compare
//   against the current k-th value; the ordered insertion runs only when it
//   wins. Several rows per thread (reusing each staged record), tensor
//   cores for x.s (which would change the rounding) and splitting the
//   corpus across blocks with a merge are later work.
//
// Exactness: the similarity is summed over features in ascending order
//   with every product and sum rounded on its own, then the half norm is
//   subtracted -- the order of the plain version (models/knn.py
//   dot_expansion_sim), so the values agree bit for bit. The corpus is
//   scanned in ascending index order; a candidate enters only if it is
//   strictly greater than the k-th value, and on insertion it moves past
//   only entries strictly smaller than it. So equal values keep ascending
//   index order, the order of a stable descending sort and of lax.top_k.
//
// Corpus records: (S, 16) float32, features 0..F-1 (F <= 15), zeros, and
//   0.5|s|^2 in slot 15.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/cuda_build.py does this at first use).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;       // corpus records per shared-memory stage
constexpr int kRecord = 16;       // floats per corpus record
constexpr int kMaxFeatures = 15;  // slot 15 holds the half norm
constexpr int kMaxNeighbors = 128;

template <int KMAX>
__global__ void __launch_bounds__(kThreads) knn_topk_kernel(
    const float* __restrict__ X, int n_rows, int n_features,
    const float4* __restrict__ records, int n_corpus, int k,
    float* __restrict__ out_vals, int* __restrict__ out_idx) {
  __shared__ float4 tile[kChunk * (kRecord / 4)];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < n_rows;

  float x[kMaxFeatures];
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) {
    x[f] = (active && f < n_features)
               ? X[static_cast<size_t>(row) * n_features + f]
               : 0.0f;
  }
  float vals[KMAX];
  int idx[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    vals[q] = -CUDART_INF_F;
    idx[q] = 0;
  }
  float kth = -CUDART_INF_F;  // vals[k - 1]

  for (int base = 0; base < n_corpus; base += kChunk) {
    const int n = min(kChunk, n_corpus - base);
    __syncthreads();  // the previous stage is consumed
    for (int i = threadIdx.x; i < n * (kRecord / 4); i += kThreads) {
      tile[i] = __ldg(records + static_cast<size_t>(base) * (kRecord / 4) + i);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      float r[kRecord];
#pragma unroll
      for (int q = 0; q < kRecord / 4; ++q) {
        const float4 v = tile[j * (kRecord / 4) + q];
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
      float acc = __fmul_rn(x[0], r[0]);
#pragma unroll
      for (int f = 1; f < kMaxFeatures; ++f) {
        if (f < n_features) acc = __fadd_rn(acc, __fmul_rn(x[f], r[f]));
      }
      const float sim = __fsub_rn(acc, r[kRecord - 1]);
      if (!(sim > kth)) continue;
      // ordered insertion: entries strictly smaller than sim move down one
      const int s = base + j;
#pragma unroll
      for (int q = KMAX - 1; q > 0; --q) {
        if (q < k) {
          if (vals[q - 1] < sim) {
            vals[q] = vals[q - 1];
            idx[q] = idx[q - 1];
          } else if (vals[q] < sim) {
            vals[q] = sim;
            idx[q] = s;
          }
        }
      }
      if (vals[0] < sim) {
        vals[0] = sim;
        idx[0] = s;
      }
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (q == k - 1) kth = vals[q];
      }
    }
  }

  if (!active) return;
  const size_t o = static_cast<size_t>(row) * k;
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    if (q < k) {
      out_vals[o + q] = vals[q];
      out_idx[o + q] = idx[q];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `records` must be 16-byte aligned.
// Requires 1 <= k <= min(128, n_corpus) and 1 <= n_features <= 15.
extern "C" int knn_topk_launch(
    const void* X, int n_rows, int n_features,
    const void* records, int n_corpus, int k,
    void* out_vals, void* out_idx, void* stream) {
  if (n_rows < 0 || n_features < 1 || n_features > kMaxFeatures || k < 1 ||
      k > kMaxNeighbors || n_corpus < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(X);
  const auto* rec = static_cast<const float4*>(records);
  auto* ov = static_cast<float*>(out_vals);
  auto* oi = static_cast<int*>(out_idx);
  if (k <= 8) {
    knn_topk_kernel<8><<<blocks, kThreads, 0, s>>>(
        x, n_rows, n_features, rec, n_corpus, k, ov, oi);
  } else {
    knn_topk_kernel<kMaxNeighbors><<<blocks, kThreads, 0, s>>>(
        x, n_rows, n_features, rec, n_corpus, k, ov, oi);
  }
  return static_cast<int>(cudaGetLastError());
}
