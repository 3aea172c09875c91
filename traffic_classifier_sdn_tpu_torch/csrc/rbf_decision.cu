// RBF-SVC one-vs-one decision values on Hopper (sm_90a): a block owns R
// rows and walks the support vectors (SVs) in stages of 32, computing the
// R x 32 tile of kernel values in parallel and then adding it into the
// R x P sums, so the (N, S) kernel matrix never exists in memory.
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
// What bounds it on the card: instruction issue. Per (row, SV) pair it
//   does 4F operations for d2, one multiply and one expf, and P
//   multiply-adds (~80 operations for F = 12, P = 15) while a row moves 48
//   (or 96, with x_lo) bytes in and 4P bytes out; the SV records (2281 x
//   192 bytes for the reference) stay in L2. Every product and sum is
//   rounded on its own (no FMA), so each operation is one instruction, and
//   with the shared-memory loads a pair costs about 100-110 issue slots.
//
// What the design does about it:
//   - Phase 1: every thread of the block computes kernel values of the
//     stage's R x 32 tile (row fixed per thread, x in registers, several
//     independent SV chains per thread, unguarded in a full stage so
//     they interleave), writing K to shared memory.
//   - Phase 2: one thread per (row, group of pairs) adds K[row, s] *
//     coef[s, p] for s ascending, its 4 coefficients of a support vector
//     in one 16-byte load at R = 64; the sums stay in registers for the
//     whole walk, so each (row, pair) sum is owned by one thread.
//   - The records of the next stage arrive by cp.async while the current
//     one computes; three record buffers and two K tiles (phase 2 lags
//     phase 1 by one stage) need one barrier per stage.
//   - R is chosen from N by the wrapper (4, 16 or 64 rows per block;
//     ops/rbf_kernel.py launch_shape), so that a few hundred rows still
//     fill the card with blocks and 2^20 rows do not re-read the SV
//     records once per handful of rows.
//   - F = 12 and P = 15 (the reference model) are compile-time constants
//     in one instance, so its inner loops carry no predicates; another
//     instance takes any F <= 16 and P <= 15.
//   Records are padded to 52 floats in shared memory, so threads reading
//   different records at once hit different banks.
//
// Exactness: d2 is summed over features in ascending order, K is
//   expf((-gamma) * d2), and acc[p] starts at 0 and adds K * coef[s][p] for
//   s in ascending order, each product and sum rounded on its own -- the
//   order of the plain version (models/svc.py sq_dist / decision_sum), so
//   the two agree bit for bit wherever this expf and torch.exp agree. The
//   order does not depend on R. Without x_lo, the difference is
//   (x - shi) - slo, bitwise (x - shi) + (0 - slo), which is what the TPU
//   kernel computes with zeros. Built without fast math, so expf is the
//   accurate libm-style function, not __expf. No atomics.
//
// Support-vector records: (S, 48) float32 -- sv_hi in slots 0..15, sv_lo
//   in 16..31, the P coefficients of that support vector in 32..47 (F <= 16,
//   P <= 15; unused slots zero).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/cuda_build.py does this at first use).

#include <cuda_runtime.h>

#include <cstddef>

#include "cp_async.cuh"

namespace {

constexpr int kStage = 32;       // support vectors per stage
constexpr int kRecord4 = 12;     // float4 per support-vector record
constexpr int kSmemRecord4 = 13;  // the same, padded in shared memory
constexpr int kMaxFeatures = 16;
constexpr int kLo4 = 4;    // float4 index of sv_lo
constexpr int kCoef = 32;  // float index of the coefficients
constexpr int kMaxPairs = 15;

__host__ __device__ constexpr int threads_for(int R) {
  return 32 * R < 256 ? 32 * R : 256;
}

// R rows per block; F features and P pairs fixed at compile time, or 0
// for the runtime values n_features / n_pairs.
template <int R, int F, int P, bool kHasXlo>
__global__ void __launch_bounds__(threads_for(R)) rbf_decision_kernel(
    const float* __restrict__ X, const float* __restrict__ X_lo, int n_rows,
    int n_features, const float4* __restrict__ records, int n_sv,
    int n_pairs, float neg_gamma, float* __restrict__ out) {
  constexpr int kThreads = threads_for(R);
  constexpr int kSubs = kThreads / R;        // threads per row in phase 1
  constexpr int kPerThread = kStage / kSubs;  // phase-1 pairs per thread
  constexpr int kGroups = kSubs < kMaxPairs ? kSubs : kMaxPairs;
  constexpr int kPP = (kMaxPairs + kGroups - 1) / kGroups;  // pairs per group
  constexpr int kF = F > 0 ? F : kMaxFeatures;
  static_assert(kStage % kSubs == 0, "phase 1 covers the stage exactly");

  __shared__ __align__(16) float4 sv[3][kStage * kSmemRecord4];
  __shared__ float kt[2][kStage * R];  // K tile, [s][row]

  const int nf = F > 0 ? F : n_features;
  const int np = P > 0 ? P : n_pairs;
  const int t = threadIdx.x;
  const int row_l = t % R;
  const int sub = t / R;
  const int row = blockIdx.x * R + row_l;
  const bool active = row < n_rows;

  // phase-1 operands: this thread's row
  float x[kF];
  float xl[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const bool use = active && (F > 0 || f < nf);
    const size_t at = static_cast<size_t>(row) * nf + f;
    x[f] = use ? X[at] : 0.0f;
    xl[f] = (kHasXlo && use) ? X_lo[at] : 0.0f;
  }
  // phase-2 sums: (row_l, pairs [sub * kPP, sub * kPP + kPP))
  const bool summer = sub < kGroups;
  const int p0 = sub * kPP;
  float acc[kPP];
#pragma unroll
  for (int i = 0; i < kPP; ++i) acc[i] = 0.0f;

  const int n_stages = (n_sv + kStage - 1) / kStage;
  auto load_stage = [&](int st) {
    const int base = st * kStage;
    const int n = min(kStage, n_sv - base);
    float4* dst = sv[st % 3];
    const float4* src = records + static_cast<size_t>(base) * kRecord4;
    for (int i = t; i < n * kRecord4; i += kThreads) {
      const int j = i / kRecord4;
      tcsdn::cp_async16(dst + j * kSmemRecord4 + (i - j * kRecord4), src + i);
    }
    tcsdn::cp_async_commit();
  };

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st <= n_stages; ++st) {
    tcsdn::cp_async_wait_all();
    __syncthreads();  // stage st landed; phase 2 of st - 2 is done
    if (st + 1 < n_stages) load_stage(st + 1);

    if (st < n_stages) {  // phase 1: K of stage st
      const int n = min(kStage, n_sv - st * kStage);
      const float4* rec = sv[st % 3];
      float* k_out = kt[st & 1];
      auto kernel_value = [&](int j) {
        const float* r = reinterpret_cast<const float*>(rec + j * kSmemRecord4);
        float d2 = 0.0f;
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          if (F > 0 || f < nf) {
            const float dh = __fsub_rn(x[f], r[f]);
            const float diff =
                kHasXlo ? __fadd_rn(dh, __fsub_rn(xl[f], r[4 * kLo4 + f]))
                        : __fsub_rn(dh, r[4 * kLo4 + f]);
            const float sq = __fmul_rn(diff, diff);
            d2 = (f == 0) ? sq : __fadd_rn(d2, sq);
          }
        }
        k_out[j * R + row_l] = expf(__fmul_rn(neg_gamma, d2));
      };
      if (n == kStage) {  // a full stage: no guard, the chains interleave
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) kernel_value(sub + m * kSubs);
      } else {
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) {
          if (sub + m * kSubs < n) kernel_value(sub + m * kSubs);
        }
      }
    }

    if (st > 0 && summer) {  // phase 2: sums of stage st - 1
      const int ps = st - 1;
      const int n = min(kStage, n_sv - ps * kStage);
      const float* k_in = kt[ps & 1];
      const float4* rec = sv[ps % 3];
      auto add = [&](int s) {
        const float kv = k_in[s * R + row_l];
        const float* c = reinterpret_cast<const float*>(rec + s * kSmemRecord4) +
                         kCoef + p0;
        float cf[kPP];
        if constexpr (kPP == 4) {  // this thread's 4 coefficients, one load
          const float4 c4 = *reinterpret_cast<const float4*>(c);
          cf[0] = c4.x;
          cf[1] = c4.y;
          cf[2] = c4.z;
          cf[3] = c4.w;
        } else {
#pragma unroll
          for (int i = 0; i < kPP; ++i) cf[i] = c[i];
        }
#pragma unroll
        for (int i = 0; i < kPP; ++i) {
          if (P > 0 ? (p0 + i < P) : (p0 + i < np)) {
            acc[i] = __fadd_rn(acc[i], __fmul_rn(kv, cf[i]));
          }
        }
      };
      if (n == kStage) {
#pragma unroll
        for (int s = 0; s < kStage; ++s) add(s);
      } else {
        for (int s = 0; s < n; ++s) add(s);
      }
    }
  }

  if (!active || !summer) return;
  float* o = out + static_cast<size_t>(row) * np;
#pragma unroll
  for (int i = 0; i < kPP; ++i) {
    if (p0 + i < np) o[p0 + i] = acc[i];
  }
}

template <int R, int F, int P>
void launch_rows(bool has_xlo, int blocks, cudaStream_t s, const float* x,
                 const float* xlo, int n_rows, int n_features,
                 const float4* rec, int n_sv, int n_pairs, float neg_gamma,
                 float* o) {
  if (has_xlo) {
    rbf_decision_kernel<R, F, P, true><<<blocks, threads_for(R), 0, s>>>(
        x, xlo, n_rows, n_features, rec, n_sv, n_pairs, neg_gamma, o);
  } else {
    rbf_decision_kernel<R, F, P, false><<<blocks, threads_for(R), 0, s>>>(
        x, xlo, n_rows, n_features, rec, n_sv, n_pairs, neg_gamma, o);
  }
}

template <int F, int P>
int launch(int rows_per_block, bool has_xlo, cudaStream_t s, const float* x,
           const float* xlo, int n_rows, int n_features, const float4* rec,
           int n_sv, int n_pairs, float neg_gamma, float* o) {
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  switch (rows_per_block) {
    case 4:
      launch_rows<4, F, P>(has_xlo, blocks, s, x, xlo, n_rows, n_features,
                           rec, n_sv, n_pairs, neg_gamma, o);
      break;
    case 16:
      launch_rows<16, F, P>(has_xlo, blocks, s, x, xlo, n_rows, n_features,
                            rec, n_sv, n_pairs, neg_gamma, o);
      break;
    case 64:
      launch_rows<64, F, P>(has_xlo, blocks, s, x, xlo, n_rows, n_features,
                            rec, n_sv, n_pairs, neg_gamma, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `X_lo` may be null; `records` must be
// 16-byte aligned. Requires 1 <= n_features <= 16, 1 <= n_pairs <= 15 and
// rows_per_block in {4, 16, 64}.
extern "C" int rbf_decision_launch(
    const void* X, const void* X_lo, int n_rows, int n_features,
    const void* records, int n_sv, int n_pairs, float gamma,
    int rows_per_block, void* out, void* stream) {
  if (n_rows < 0 || n_features < 1 || n_features > kMaxFeatures ||
      n_pairs < 1 || n_pairs > kMaxPairs || n_sv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(X);
  const auto* xlo = static_cast<const float*>(X_lo);
  const auto* rec = static_cast<const float4*>(records);
  auto* o = static_cast<float*>(out);
  const bool has_xlo = xlo != nullptr;
  if (n_features == 12 && n_pairs == 15) {
    return launch<12, 15>(rows_per_block, has_xlo, s, x, xlo, n_rows,
                          n_features, rec, n_sv, n_pairs, -gamma, o);
  }
  return launch<0, 0>(rows_per_block, has_xlo, s, x, xlo, n_rows, n_features,
                      rec, n_sv, n_pairs, -gamma, o);
}
