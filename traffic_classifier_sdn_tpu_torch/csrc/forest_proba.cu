// Random-forest class probabilities on Hopper (sm_90a): one thread per row
// walks every tree and sums the reached leaves' class distributions.
//
// Replaces: traffic_classifier_sdn_tpu/ops/pallas_forest.py
//   forest_proba_pallas / _kernel (the fused GEMM-form TPU kernel). It
//   computes the same (N, C) ensemble-mean probabilities; predict is the
//   argmax. The TPU form (one-hot column select, block-diagonal ±1 path
//   matrices packing 128/D trees per MXU tile, depth-match select) exists
//   for the MXU and is not carried over.
//
// What bounds it on the card: neither the bytes nor the arithmetic. Per
//   row it reads 48 bytes of X and writes 24 bytes of output, and does one
//   compare per node visit plus C adds per tree (~860 visits and ~600 adds
//   for the reference-shaped forest). Both bounds are microseconds at 2^20
//   rows. The walk is a chain of dependent loads — the next node's address
//   is known only after the current node's compare — so the kernel is
//   bound by load latency through L1/L2.
//
// What the design does about it: each node visit is ONE 16-byte load of an
//   interleaved record {feature, threshold bits, left code, right code}
//   through the read-only path, so a visit costs one round trip instead of
//   four; the X element is read through the same cache (the row's 48 bytes
//   stay resident in L1); the C running sums live in registers; and with a
//   thread per row, 2^16..2^20 independent walks are in flight to cover the
//   latency. The whole forest (well under 1 MB) stays in L2. Staging nodes
//   in shared memory and warp-cooperative layouts are later work.
//
// Exactness: the sum runs in tree order with no atomics, so the result is
//   bit-identical to the plain PyTorch version (ops/tree_gemm.py, which adds
//   the same leaf rows in the same order). The decision is x[f] <= thr,
//   true goes left (NaN goes right), the same predicate as pm = +1 on a
//   left edge of the GEMM form.
//
// Child codes: c >= 0 is an internal node of the same tree; c < 0 is the
//   leaf slot -1 - c of that tree's row of leaf_values (T, L, C).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/cuda_build.py does this at first use).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxClasses = 16;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) forest_proba_kernel(
    const float* __restrict__ X, int n_rows, int n_features,
    const int4* __restrict__ nodes, int n_trees, int n_internal,
    const float* __restrict__ leaf_values, int n_leaves, int n_classes,
    float* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const float* x = X + static_cast<size_t>(row) * n_features;

  float acc[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) acc[c] = 0.0f;

  for (int t = 0; t < n_trees; ++t) {
    const int4* tree = nodes + static_cast<size_t>(t) * n_internal;
    int code = 0;
    do {
      const int4 nd = __ldg(tree + code);
      const float xv = __ldg(x + nd.x);
      code = (xv <= __int_as_float(nd.y)) ? nd.z : nd.w;
    } while (code >= 0);
    const float* lv = leaf_values +
        (static_cast<size_t>(t) * n_leaves + (-1 - code)) * n_classes;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < n_classes) acc[c] += __ldg(lv + c);
    }
  }

  float* o = out + static_cast<size_t>(row) * n_classes;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    if (c < n_classes) o[c] = acc[c];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `nodes` must be 16-byte aligned.
extern "C" int forest_proba_launch(
    const void* X, int n_rows, int n_features,
    const void* nodes, int n_trees, int n_internal,
    const void* leaf_values, int n_leaves, int n_classes,
    void* out, void* stream) {
  if (n_rows < 0 || n_classes < 1 || n_classes > kMaxClasses ||
      n_trees < 0 || n_internal < 1 || n_leaves < 1 || n_features < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  forest_proba_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), n_rows, n_features,
      static_cast<const int4*>(nodes), n_trees, n_internal,
      static_cast<const float*>(leaf_values), n_leaves, n_classes,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
