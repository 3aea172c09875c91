// Brute-force k-nearest-neighbor top-k on Hopper (sm_90a). Each warp walks
// its rows against 128 corpus records at a time, four records held in the
// registers of each lane, and keeps each row's running top-k spread over
// its 32 lanes. The (N, S) similarity matrix never exists in memory.
//
// Replaces: traffic_classifier_sdn_tpu/ops/pallas_knn.py topk_sim_idx /
//   _kernel (the fused distance + running top-k TPU kernel). It computes
//   the same ((N, k) similarities, (N, k) indices): sim = x.s - 0.5|s|^2,
//   the k largest by (value desc, index asc), which is lax.top_k's order.
//   The TPU form (an MXU dot per 512 x 512 tile, k max-and-mask passes, a
//   rank-based carry merge across grid steps) exists for the MXU and the
//   sequential grid and is not carried over.
//
// What bounds it on the card: instruction issue. Per (row, corpus row)
//   pair it does F multiplies, F - 1 adds, one subtract and one compare,
//   while a row moves 48 bytes in and 8k bytes out; the reference corpus
//   (4448 rows x 64 bytes) stays in L2. The products and sums are rounded
//   one by one (__fmul_rn / __fadd_rn, no FMA), so the kernel issues 2F
//   instructions per pair where the card's float32 peak counts an FMA as
//   two operations: it cannot pass half of that peak.
//
// What the design does about it (the shape comes from the wrapper,
//   ops/knn_kernel.py launch_shape):
//   - Corpus-stationary inner loop. A lane loads four records of a
//     128-record chunk into registers once and computes their similarity
//     to each of the warp's rows in turn (up to 16): four independent
//     chains per row, the row's x a broadcast from shared memory, loaded
//     a row ahead with the row's k-th value. A row step is the 100
//     arithmetic instructions of its 128 pairs, a few loads, and one
//     branch, taken when a candidate may beat the row's k-th value.
//   - The top-k list of a row lives in shared memory, slot e in
//     lane e % 32 (k <= 32: one slot per lane; k <= 128: four, the other
//     instance). A row step reads only the k-th value. When a candidate
//     may beat it (about 11 of a row's 35 chunks for k = 5 and the reference
//     corpus), the warp loads the list into its lanes and inserts the
//     winners one by one: a ballot counts the entries that stay ahead, a
//     shuffle moves the rest down. The first chunk, into an empty list,
//     is taken instead by k rounds of a warp argmax.
//   - Records arrive 512 per stage by cp.async into a second buffer while
//     the current stage is scanned; one barrier per stage. The stage is
//     swizzled so the lanes' 16-byte loads hit distinct banks.
//   - Each warp scans the whole corpus for its rows, so a row's list is
//     the answer and is written out as it stands. Small N gets fewer rows
//     per warp (down to one) and so more blocks. (A split of the corpus
//     over warps or blocks, with a merge of the lists, is exact too, but
//     timed slower than one row per warp at 777 rows: PERF.md.)
//   - F = 12 is a compile-time constant in one instance (three 16-byte
//     loads a row or record, no predicates); another takes any F <= 15.
//
// Exactness: the similarity is summed over features in ascending order
//   with every product and sum rounded on its own, then the half norm is
//   subtracted -- the order of the plain version (models/knn.py
//   dot_expansion_sim), so the values agree bit for bit. Candidates are
//   ranked by the total-order key of their float bits (key = bits ^
//   ((bits >> 31) & 0x7fffffff), as int32; models/knn.py
//   total_order_key), so +NaN > +inf > ... > +0 > -0 > ... > -inf > -NaN,
//   as lax.top_k orders them; a key maps back to its float bits by the
//   same expression. The corpus is offered in
//   ascending index order (lane order within a column of 32, columns and
//   chunks in order); the first chunk fills the list with its k best by
//   (key desc, index asc), one warp argmax a slot (the chunk holds at
//   least min(S, 128) >= k corpus rows, so every slot takes a real
//   index); a later candidate enters only if its key is strictly greater
//   than the k-th key, and goes after every entry whose key is >= its
//   own. So the list is the top-k by (key desc, index asc) -- the order of
//   the plain version's stable descending sort and of lax.top_k -- and
//   every row, NaN or +-inf features included, gets k indices in [0, S).
//   The result does not depend on the rows per warp. Records past the
//   end of the corpus (staged as zeros with a half norm of +inf) are kept
//   out by their index, never by their value: under the total order a
//   NaN pad would outrank every real row. No atomics.
//
// The hot test is one float compare per pair, !(sim < kth) with kth the
//   k-th value: true for every candidate whose key beats the k-th (a
//   larger value, +0 over -0, a NaN), and for some that do not (an equal
//   value, a pad), which the exact key test behind it turns away. The
//   lists hold values; keys are taken only behind that test, so the hot
//   loop is the one it was before the total order.
//
// Corpus records: (S, 16) float32, features 0..F-1 (F <= 15), zeros, and
//   0.5|s|^2 in slot 15.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/cuda_build.py does this at first use).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kJ = 4;              // records per lane per chunk
constexpr int kChunk = 32 * kJ;    // records a warp takes at once
constexpr int kStageRecords = 512;  // records per stage
constexpr int kRecord4 = 4;        // float4 per corpus record
constexpr int kMaxFeatures = 15;   // slot 15 holds the half norm
constexpr int kMaxNeighbors = 128;
constexpr int kMaxRowsPerWarp = 16;
constexpr int kSentinel = INT_MAX;  // index of a slot not yet filled
constexpr unsigned kFull = 0xffffffffu;

// Lanes whose slot lane + 32 t is one of the first k.
__device__ __forceinline__ unsigned slot_mask(int k, int t) {
  const int n = k - 32 * t;
  return n >= 32 ? kFull : (n <= 0 ? 0u : (1u << n) - 1u);
}

// The total-order key of a float (see Exactness above); applied to a key
// it gives the float's bits back.
__device__ __forceinline__ int order_key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(order_key(key));
}

// k <= 32 * KS: the list spread over the warp, lane l holding slots
// l + 32 t, t < KS (key desc, index asc); an insertion is a ballot and
// shuffles. The list holds the values; their keys are taken when an
// insertion compares them.
template <int KS>
struct WarpList {
  static constexpr int kSlots = 32 * KS;
  float v[KS];
  int i[KS];

  __device__ __forceinline__ void load(const float* lv, const int* li,
                                       int lane) {
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      v[t] = lv[lane + 32 * t];
      i[t] = li[lane + 32 * t];
    }
  }

  __device__ __forceinline__ void store(float* lv, int* li, int lane) const {
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      lv[lane + 32 * t] = v[t];
      li[lane + 32 * t] = i[t];
    }
  }

  __device__ __forceinline__ int kth_key(int k) const {
    float x = v[0];
#pragma unroll
    for (int t = 1; t < KS; ++t) {
      if (((k - 1) >> 5) == t) x = v[t];
    }
    return order_key(__float_as_int(__shfl_sync(kFull, x, (k - 1) & 31)));
  }

  // Inserts (val, idx), whose key beats the k-th entry's and whose index
  // is higher than every entry's of equal key: it goes after every entry
  // whose key is >= its own (a ballot counts them), and the entries
  // behind it move down a slot.
  __device__ __forceinline__ void insert(float val, int key, int idx, int k,
                                         int lane) {
    int p = 0;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      p += __popc(__ballot_sync(kFull, order_key(__float_as_int(v[t])) >= key) &
                  slot_mask(k, t));
    }
#pragma unroll
    for (int t = KS - 1; t >= 0; --t) {
      float uv = __shfl_up_sync(kFull, v[t], 1);
      int ui = __shfl_up_sync(kFull, i[t], 1);
      if (t > 0) {  // lane 0 takes the last slot of the slice before
        const float cv = __shfl_sync(kFull, v[t > 0 ? t - 1 : 0], 31);
        const int ci = __shfl_sync(kFull, i[t > 0 ? t - 1 : 0], 31);
        if (lane == 0) {
          uv = cv;
          ui = ci;
        }
      }
      const int e = lane + 32 * t;
      if (e > p) {
        v[t] = uv;
        i[t] = ui;
      } else if (e == p) {
        v[t] = val;
        i[t] = idx;
      }
    }
  }
};

// The first chunk, into an empty list: slots 0..k-1 take the chunk's k
// best candidates by (key desc, index asc), one warp argmax a slot,
// instead of the many insertions of a list that is still filling. Lane
// l's candidate c[j] has index base + 32 j + l; one at or past
// `n_corpus` (a pad) is never taken. The chunk holds at least k corpus
// rows (S >= k), so every slot is filled.
template <int KS, int J>
__device__ __forceinline__ void fill(WarpList<KS>& list, const float (&c)[J],
                                     int base, int n_corpus, int k,
                                     int lane) {
  int ck[J];
  bool live[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ck[j] = order_key(__float_as_int(c[j]));
    live[j] = base + 32 * j + lane < n_corpus;
  }
  for (int q = 0; q < k; ++q) {
    bool bl = false;
    int bv = INT_MIN;
    int bj = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      // equal keys keep the lower column: the lower index
      if (live[j] && (!bl || ck[j] > bv)) {
        bl = true;
        bv = ck[j];
        bj = j;
      }
    }
    // a lane with no corpus row left holds index kSentinel
    int bi = bl ? base + 32 * bj + lane : kSentinel;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (oi != kSentinel && (bi == kSentinel || ov > bv ||
                              (ov == bv && oi < bi))) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi == kSentinel) return;  // none left (the host refuses S < k)
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      if (lane + 32 * t == q) {
        list.v[t] = key_value(bv);
        list.i[t] = bi;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (bi == base + 32 * j + lane) live[j] = false;
    }
  }
}

// sim = x.s - 0.5|s|^2: products and sums rounded one by one, features in
// ascending order.
template <int F, int kF>
__device__ __forceinline__ float similarity(const float (&x)[kF],
                                            const float (&r)[kF], float norm,
                                            int nf) {
  float acc = __fmul_rn(x[0], r[0]);
#pragma unroll
  for (int f = 1; f < kF; ++f) {
    if (F > 0 || f < nf) acc = __fadd_rn(acc, __fmul_rn(x[f], r[f]));
  }
  return __fsub_rn(acc, norm);
}

// Dynamic shared memory of a launch: two stages of 512 records, the
// block's rows, and the lists (`slots` each) of every (warp, row).
__host__ __device__ constexpr size_t smem_bytes(int slots, int rows_per_warp) {
  return static_cast<size_t>(2 * kStageRecords * kRecord4) * 16 +
         static_cast<size_t>(kWarps * rows_per_warp) * 64 +
         static_cast<size_t>(kWarps * rows_per_warp * slots) * 8;
}

// KS: list slots per lane (k <= 32 * KS); F: features, or 0 for the
// runtime n_features.
template <int KS, int F>
__global__ void __launch_bounds__(kThreads, 2) knn_topk_kernel(
    const float* __restrict__ X, int n_rows, int n_features,
    const float4* __restrict__ records, int n_corpus, int k,
    int rows_per_warp, float* __restrict__ out_vals,
    int* __restrict__ out_idx) {
  constexpr int kF = F > 0 ? F : kMaxFeatures;
  constexpr int kX4 = (kF + 3) / 4;  // float4 of features per row/record
  using List = WarpList<KS>;
  constexpr int kSlots = List::kSlots;
  extern __shared__ __align__(16) float4 smem[];

  const int nf = F > 0 ? F : n_features;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_block = kWarps * rows_per_warp;
  const int row0 = blockIdx.x * rows_block;
  const int my_row0 = row0 + warp * rows_per_warp;
  const int my_rows = max(0, min(rows_per_warp, n_rows - my_row0));

  float4* stage = smem;  // [2][kStageRecords][4], swizzled
  float4* xs = stage + 2 * kStageRecords * kRecord4;  // [rows_block][4]
  float* list_v = reinterpret_cast<float*>(xs + rows_block * 4);
  int* list_i = reinterpret_cast<int*>(list_v + kWarps * rows_per_warp * kSlots);

  {
    float* xf = reinterpret_cast<float*>(xs);
    for (int q = threadIdx.x; q < rows_block * 16; q += kThreads) {
      const int row = row0 + q / 16;
      const int f = q % 16;
      xf[q] = (row < n_rows && f < nf) ? X[static_cast<size_t>(row) * nf + f]
                                       : 0.0f;
    }
    for (int q = threadIdx.x; q < kWarps * rows_per_warp * kSlots;
         q += kThreads) {
      list_v[q] = -CUDART_INF_F;
      list_i[q] = kSentinel;
    }
  }
  __syncthreads();

  const int n_stages = (n_corpus + kStageRecords - 1) / kStageRecords;
  auto load_stage = [&](int st) {
    float4* dst = stage + (st & 1) * kStageRecords * kRecord4;
    for (int q = threadIdx.x; q < kStageRecords * kRecord4; q += kThreads) {
      const int e = q / kRecord4;
      const int part = q % kRecord4;
      const int rec = st * kStageRecords + e;
      float4* d = dst + e * kRecord4 + (part ^ ((e >> 1) & 3));
      if (rec < n_corpus) {
        tcsdn::cp_async16(d, records + static_cast<size_t>(rec) * kRecord4 + part);
      } else {  // past the corpus: kept out by its index
        *d = make_float4(0.0f, 0.0f, 0.0f, part == 3 ? CUDART_INF_F : 0.0f);
      }
    }
    tcsdn::cp_async_commit();
  };

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    tcsdn::cp_async_wait_all();
    __syncthreads();  // stage st landed; stage st - 1 is consumed
    if (st + 1 < n_stages) load_stage(st + 1);
    if (my_rows == 0) continue;

    for (int cc = 0; cc < kStageRecords / kChunk; ++cc) {
      // this lane's records: kJ columns of 32, record 32 j + lane of chunk cc
      const float4* sub =
          stage + ((st & 1) * kStageRecords + cc * kChunk) * kRecord4;
      const int swz = (lane >> 1) & 3;
      float r[kJ][kF];
      float norm[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4* rp = sub + (32 * j + lane) * kRecord4;
#pragma unroll
        for (int q = 0; q < kX4; ++q) {
          const float4 v = rp[q ^ swz];
          const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (4 * q + u < kF) r[j][4 * q + u] = w[u];
          }
        }
        norm[j] = reinterpret_cast<const float*>(rp + (3 ^ swz))[3];
      }
      const int base = st * kStageRecords + cc * kChunk;

      // x and the k-th value of the next row are loaded one row ahead
      float4 xn[kX4];
      float kn;
      {
        const float4* xr = xs + (warp * rows_per_warp) * 4;
#pragma unroll
        for (int q = 0; q < kX4; ++q) xn[q] = xr[q];
        kn = list_v[(warp * rows_per_warp) * kSlots + k - 1];
      }
      for (int i = 0; i < my_rows; ++i) {
        float x[kF];
#pragma unroll
        for (int q = 0; q < kX4; ++q) {
          const float w[4] = {xn[q].x, xn[q].y, xn[q].z, xn[q].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (4 * q + u < kF) x[4 * q + u] = w[u];
          }
        }
        float kth = kn;
        if (i + 1 < my_rows) {  // the next row's x, in flight
          const float4* xr = xs + (warp * rows_per_warp + i + 1) * 4;
#pragma unroll
          for (int q = 0; q < kX4; ++q) xn[q] = xr[q];
        }
        float* lv = list_v + (warp * rows_per_warp + i) * kSlots;
        int* li = list_i + (warp * rows_per_warp + i) * kSlots;
        float sim[kJ];
        bool hit = false;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          sim[j] = similarity<F, kF>(x, r[j], norm[j], nf);
          hit |= !(sim[j] < kth);  // may beat the k-th key: test it
        }
        if (st == 0 && cc == 0) {  // the list is empty: fill it
          List L;
          L.load(lv, li, lane);
          fill(L, sim, base, n_corpus, k, lane);
          L.store(lv, li, lane);
          __syncwarp();
        } else if (__any_sync(kFull, hit)) {  // some candidate may enter
          List L;
          L.load(lv, li, lane);
          int kkey = order_key(__float_as_int(kth));
          int key[kJ];
          unsigned m[kJ];  // the corpus rows whose key beats kth, per column
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            key[j] = order_key(__float_as_int(sim[j]));
            m[j] = __ballot_sync(
                kFull, base + 32 * j + lane < n_corpus && key[j] > kkey);
          }
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            for (unsigned b = m[j]; b != 0; b &= b - 1) {  // lane order
              const int src = __ffs(b) - 1;
              const int v = __shfl_sync(kFull, key[j], src);
              if (v > kkey) {  // the k-th may have risen since the ballot
                L.insert(__shfl_sync(kFull, sim[j], src), v,
                         base + 32 * j + src, k, lane);
                kkey = L.kth_key(k);
              }
            }
          }
          L.store(lv, li, lane);
          __syncwarp();
        }
        if (i + 1 < my_rows) kn = lv[kSlots + k - 1];
      }
    }
  }
  __syncwarp();

  for (int i = 0; i < my_rows; ++i) {
    const float* lv = list_v + (warp * rows_per_warp + i) * kSlots;
    const int* li = list_i + (warp * rows_per_warp + i) * kSlots;
    const size_t o = static_cast<size_t>(my_row0 + i) * k;
    for (int e = lane; e < k; e += 32) {
      out_vals[o + e] = lv[e];
      out_idx[o + e] = li[e];
    }
  }
}

template <int KS, int F>
cudaError_t launch(int blocks, int rows_per_warp, cudaStream_t s,
                   const float* x, int n_rows, int n_features,
                   const float4* rec, int n_corpus, int k, float* ov,
                   int* oi) {
  auto* kernel = knn_topk_kernel<KS, F>;
  const size_t smem = smem_bytes(WarpList<KS>::kSlots, rows_per_warp);
  static size_t granted = 48 * 1024;  // this instance's shared memory limit
  if (smem > granted) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
    granted = smem;
  }
  kernel<<<blocks, kThreads, smem, s>>>(x, n_rows, n_features, rec, n_corpus,
                                        k, rows_per_warp, ov, oi);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_k(int blocks, int rows_per_warp, cudaStream_t s,
                     const float* x, int n_rows, int n_features,
                     const float4* rec, int n_corpus, int k, float* ov,
                     int* oi) {
  if (k <= 32) {
    return launch<1, F>(blocks, rows_per_warp, s, x, n_rows, n_features, rec,
                        n_corpus, k, ov, oi);
  }
  return launch<kMaxNeighbors / 32, F>(blocks, rows_per_warp, s, x, n_rows,
                                       n_features, rec, n_corpus, k, ov, oi);
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success). Pointers are device pointers; `records` must be 16-byte
// aligned. Requires 1 <= k <= min(128, n_corpus), 1 <= n_features <= 15
// and 1 <= rows_per_warp <= 16 (kMaxRowsPerWarp).
extern "C" int knn_topk_launch(const void* X, int n_rows, int n_features,
                               const void* records, int n_corpus, int k,
                               int rows_per_warp, void* out_vals,
                               void* out_idx, void* stream) {
  if (n_rows < 0 || n_features < 1 || n_features > kMaxFeatures || k < 1 ||
      k > kMaxNeighbors || n_corpus < k || rows_per_warp < 1 ||
      rows_per_warp > kMaxRowsPerWarp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int rows_block = kWarps * rows_per_warp;
  const int blocks = (n_rows + rows_block - 1) / rows_block;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(X);
  const auto* rec = static_cast<const float4*>(records);
  auto* ov = static_cast<float*>(out_vals);
  auto* oi = static_cast<int*>(out_idx);
  const cudaError_t err =
      n_features == 12
          ? launch_k<12>(blocks, rows_per_warp, s, x, n_rows, n_features, rec,
                         n_corpus, k, ov, oi)
          : launch_k<0>(blocks, rows_per_warp, s, x, n_rows, n_features, rec,
                        n_corpus, k, ov, oi);
  return static_cast<int>(err);
}
