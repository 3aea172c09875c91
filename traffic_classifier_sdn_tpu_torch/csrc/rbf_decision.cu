// RBF-SVC one-vs-one decision values on Hopper (sm_90a): one thread per
// row takes its distance to every support vector, the RBF value and the
// per-pair sums, so the (N, S) kernel matrix never exists in memory.
//
// Replaces: traffic_classifier_sdn_tpu/ops/pallas_rbf.py partial_decision /
//   _kernel (the fused distance + exp + vote-projection TPU kernel). It
//   computes the same (N, P) partial decisions with no intercept:
//     d2   = sum_f ((x_f - shi_f) + (xlo_f - slo_f))^2   (two-float form)
//     K    = exp(-gamma * d2)
//     acc += K * coef[s][:]
//   The TPU form (per-feature outer-product adds over a 512 x 1024 tile
//   and an MXU dot for K @ coef) exists for the VPU/MXU and is not
//   carried over.
//
// What bounds it on the card: the arithmetic. Per (row, support vector)
//   pair it does 4F operations for d2, one multiply and one expf, and P
//   multiply-adds (~80 operations for F = 12, P = 15), while a row moves
//   48 (or 96, with x_lo) bytes in and 4P bytes out. The support vectors
//   (2281 x 192 bytes for the reference) stay in L2 and every block
//   streams them through shared memory. Products and sums are rounded one
//   by one (no fused multiply-add), so no operation pairs into an FMA.
//
// What the design does about it: support-vector records are staged 128 at
//   a time in shared memory, where every thread of a block reads the same
//   record at once (a broadcast, twelve 16-byte loads per record); the row
//   and its P sums live in registers. Several rows per thread, and tensor
//   cores for K @ coef (which would change the rounding), are later work.
//
// Exactness: d2 is summed over features in ascending order, K is
//   expf((-gamma) * d2), and acc[p] starts at 0 and adds K * coef[s][p] for
//   s in ascending order, each product and sum rounded on its own -- the
//   order of the plain version (models/svc.py sq_dist / decision_sum), so
//   the two agree bit for bit wherever this expf and torch.exp agree.
//   Without x_lo, the difference is (x - shi) - slo, bitwise
//   (x - shi) + (0 - slo), which is what the TPU kernel computes with
//   zeros. Built without fast math, so expf is the accurate libm-style
//   function, not __expf.
//
// Support-vector records: (S, 48) float32 -- sv_hi in slots 0..15, sv_lo
//   in 16..31, the P coefficients of that support vector in 32..47 (F <= 16,
//   P <= 15; unused slots zero).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/cuda_build.py does this at first use).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;    // support vectors per shared-memory stage
constexpr int kRecord = 48;    // floats per support-vector record
constexpr int kMaxFeatures = 16;
constexpr int kLoSlot = 16;
constexpr int kCoefSlot = 32;
constexpr int kMaxPairs = 15;

template <bool kHasXlo>
__global__ void __launch_bounds__(kThreads) rbf_decision_kernel(
    const float* __restrict__ X, const float* __restrict__ X_lo, int n_rows,
    int n_features, const float4* __restrict__ records, int n_sv,
    int n_pairs, float neg_gamma, float* __restrict__ out) {
  __shared__ float4 tile[kChunk * (kRecord / 4)];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < n_rows;

  float x[kMaxFeatures];
  float xl[kMaxFeatures];
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) {
    const bool use = active && f < n_features;
    const size_t at = static_cast<size_t>(row) * n_features + f;
    x[f] = use ? X[at] : 0.0f;
    xl[f] = (kHasXlo && use) ? X_lo[at] : 0.0f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) acc[p] = 0.0f;

  for (int base = 0; base < n_sv; base += kChunk) {
    const int n = min(kChunk, n_sv - base);
    __syncthreads();  // the previous stage is consumed
    for (int i = threadIdx.x; i < n * (kRecord / 4); i += kThreads) {
      tile[i] = __ldg(records + static_cast<size_t>(base) * (kRecord / 4) + i);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float* r = reinterpret_cast<const float*>(tile + j * (kRecord / 4));
      float d2 = 0.0f;
#pragma unroll
      for (int f = 0; f < kMaxFeatures; ++f) {
        if (f < n_features) {
          const float dh = __fsub_rn(x[f], r[f]);
          const float diff = kHasXlo
                                 ? __fadd_rn(dh, __fsub_rn(xl[f], r[kLoSlot + f]))
                                 : __fsub_rn(dh, r[kLoSlot + f]);
          const float sq = __fmul_rn(diff, diff);
          d2 = (f == 0) ? sq : __fadd_rn(d2, sq);
        }
      }
      const float kv = expf(__fmul_rn(neg_gamma, d2));
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        if (p < n_pairs) {
          acc[p] = __fadd_rn(acc[p], __fmul_rn(kv, r[kCoefSlot + p]));
        }
      }
    }
  }

  if (!active) return;
  float* o = out + static_cast<size_t>(row) * n_pairs;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    if (p < n_pairs) o[p] = acc[p];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `X_lo` may be null; `records` must be
// 16-byte aligned. Requires 1 <= n_features <= 16 and 1 <= n_pairs <= 15.
extern "C" int rbf_decision_launch(
    const void* X, const void* X_lo, int n_rows, int n_features,
    const void* records, int n_sv, int n_pairs, float gamma, void* out,
    void* stream) {
  if (n_rows < 0 || n_features < 1 || n_features > kMaxFeatures ||
      n_pairs < 1 || n_pairs > kMaxPairs || n_sv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(X);
  const auto* xlo = static_cast<const float*>(X_lo);
  const auto* rec = static_cast<const float4*>(records);
  auto* o = static_cast<float*>(out);
  if (xlo != nullptr) {
    rbf_decision_kernel<true><<<blocks, kThreads, 0, s>>>(
        x, xlo, n_rows, n_features, rec, n_sv, n_pairs, -gamma, o);
  } else {
    rbf_decision_kernel<false><<<blocks, kThreads, 0, s>>>(
        x, xlo, n_rows, n_features, rec, n_sv, n_pairs, -gamma, o);
  }
  return static_cast<int>(cudaGetLastError());
}
