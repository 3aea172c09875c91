// Random-forest class probabilities on Hopper (sm_90a). The forest's tree
// blobs sit in shared memory. At small N a block's 32 warps walk (tree,
// 32 rows) pairs and then sum the reached leaves in tree order (the tile
// design); at large N a thread per row walks every tree and adds each
// reached leaf at once (the row design).
//
// Replaces: traffic_classifier_sdn_tpu/ops/pallas_forest.py
//   forest_proba_pallas / _kernel (the fused GEMM-form TPU kernel). It
//   computes the same (N, C) ensemble-mean probabilities; predict is the
//   argmax. The TPU form (one-hot column select, block-diagonal +-1 path
//   matrices packing 128/D trees per MXU tile, depth-match select) exists
//   for the MXU and is not carried over.
//
// What bounds it on the card: neither the bytes nor the arithmetic. Per
//   row it reads 48 bytes of X and writes 24 bytes, and does one compare
//   per node visit plus C adds per tree (~580 visits and 600 adds for the
//   reference-shaped forest): both bounds are microseconds at 2^20 rows.
//   A walk is a chain of dependent loads (the next record is known only
//   after this one's compare). With few warps an SM (small N) the latency
//   of that chain sets the time; with 32 warps an SM walking (2^20 rows)
//   the SM's rate of instructions and shared loads does: loading both
//   children ahead, or walking two trees at once, hides latency with more
//   instructions and was slower there (PERF.md, Findings).
//
// What the design does about it:
//   - The tree blobs (8-byte node records, then the tree's leaf values)
//     arrive in shared memory by cp.async, so a load in the chain is a
//     shared-memory round trip, not one to L2. A forest larger than one
//     stage is walked in chunks of whole trees, in tree order; a one-stage
//     forest is staged once per block, and the block loops over row tiles
//     (at most one block per SM).
//   - Tile design (32 or 128 rows per tile, 1024 threads): a warp walks
//     one tree for 32 rows of the tile (lane = row) and writes the reached
//     leaf slot to shared memory; then one thread per (row, class) adds
//     leaf_values[t][slot][c] for the chunk's trees in order, its sum in a
//     register across chunks. The tile's rows x the trees give many short
//     independent chains where a thread per row has one long one.
//   - Row design (rows_per_tile threads of 256-1024, one per row): no
//     slots, no second phase, no barrier after the forest is staged, and
//     the fewest instructions a visit, which is what counts once 32 warps
//     an SM walk at once.
//   - The X tile holds each row's effective feature values (below),
//     computed once when the row is staged; the row design keeps it as
//     [feature][row], so a warp's loads never share a bank.
//   - The wrapper (ops/forest_kernel.py launch_shape) picks the design and
//     the tile from N, and the trees per stage from the forest's size.
//
// Exactness: each class's sum starts at 0 and adds the trees' leaf values
//   in tree order, one rounding per add, no atomics -- the order of the
//   plain version (ops/tree_gemm.py), so the two agree bit for bit at every
//   launch shape. The decision is x <= thr, true goes left (NaN goes
//   right), the same predicate as pm = +1 on a left edge of the GEMM form.
//   The GEMM form selects the feature as X @ feat_onehot, where NaN*0 and
//   inf*0 are NaN: so a feature's effective value is x[f] when every other
//   feature of the row is finite, and NaN otherwise. The staging computes
//   exactly that.
//
// Tree blob (ops/forest_kernel.py tree_blobs): node_words words of
//   records {threshold bits, feature | left << 6 | right << 19}, then the
//   tree's (L, C) leaf values; blob_words is a multiple of 4. A child code
//   c < n_internal is an internal node of the same tree, c >= n_internal
//   the leaf slot c - n_internal.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/cuda_build.py does this at first use).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxClasses = 16;
constexpr int kMaxTileRows = 128;  // tile design: up to 128 rows a tile
constexpr int kMaxItems = kMaxTileRows * kMaxClasses / kMaxThreads;
constexpr int kFeatureBits = 6;
constexpr int kMaxFeatures = 1 << kFeatureBits;
constexpr int kChildBits = 13;
constexpr unsigned kChildMask = (1u << kChildBits) - 1;
constexpr int kSmemBytes = 232448;

struct Args {
  const float* X;
  int n_rows, n_features;
  const int4* forest;
  int n_trees, n_internal, node_words, blob_words, n_classes;
  int rows_per_tile, trees_per_chunk;
  float* out;
};

__device__ __forceinline__ unsigned feature(uint2 nd) {
  return nd.y & (kMaxFeatures - 1);
}
__device__ __forceinline__ unsigned left(uint2 nd) {
  return (nd.y >> kFeatureBits) & kChildMask;
}
__device__ __forceinline__ unsigned right(uint2 nd) {
  return nd.y >> (kFeatureBits + kChildBits);
}

// Starts the cp.async copies of chunk `chunk`'s tree blobs into `stage`.
__device__ __forceinline__ void stage_chunk(const Args& a, unsigned* stage,
                                            int chunk) {
  const int t0 = chunk * a.trees_per_chunk;
  const int n16 = min(a.trees_per_chunk, a.n_trees - t0) * a.blob_words / 4;
  const int4* src = a.forest + static_cast<size_t>(t0) * a.blob_words / 4;
  int4* dst = reinterpret_cast<int4*>(stage);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    tcsdn::cp_async16(dst + i, src + i);
  }
  tcsdn::cp_async_commit();
}

// Writes row `row`'s effective feature values to xr[f * stride]: x[f]
// where every other feature of the row is finite, else NaN (zeros past
// the last row).
__device__ __forceinline__ void stage_row(const Args& a, int row, float* xr,
                                          int stride) {
  const int F = a.n_features;
  if (row >= a.n_rows) {
    for (int f = 0; f < F; ++f) xr[f * stride] = 0.0f;
    return;
  }
  const float* x = a.X + static_cast<size_t>(row) * F;
  int n_bad = 0;
  int bad = 0;
  for (int f = 0; f < F; ++f) {
    if (!isfinite(x[f])) {
      ++n_bad;
      bad = f;
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int f = 0; f < F; ++f) {
    xr[f * stride] = (n_bad == 0 || (n_bad == 1 && f == bad)) ? x[f] : nan;
  }
}

// Walks one tree from its root to a leaf code (>= D); x[f * stride] is
// the row's feature f. Each visit is two dependent shared loads: the
// record, then the feature value it names.
__device__ __forceinline__ unsigned walk(const uint2* rec, unsigned D,
                                         const float* x, int stride) {
  unsigned code = 0;
  do {
    const uint2 nd = rec[code];
    code = x[feature(nd) * stride] <= __uint_as_float(nd.x) ? left(nd)
                                                           : right(nd);
  } while (code < D);
  return code;
}

__device__ void tile_design(const Args& a, unsigned char* smem) {
  const int R = a.rows_per_tile;
  const int xs = a.n_features | 1;  // odd row stride of the X tile
  unsigned* stage = reinterpret_cast<unsigned*>(smem);
  float* xt = reinterpret_cast<float*>(
      smem + static_cast<size_t>(a.trees_per_chunk) * a.blob_words * 4);
  uint16_t* slots = reinterpret_cast<uint16_t*>(xt + R * xs);  // [tree][row]
  const unsigned D = static_cast<unsigned>(a.n_internal);
  const int C = a.n_classes;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int groups = R / 32;
  const int items = R * C;
  const int n_tiles = (a.n_rows + R - 1) / R;
  const int n_chunks = (a.n_trees + a.trees_per_chunk - 1) / a.trees_per_chunk;

  if (n_chunks == 1) stage_chunk(a, stage, 0);  // kept for every tile
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * R;
    if (t < R) stage_row(a, row0 + t, xt + t * xs, 1);
    float acc[kMaxItems];
#pragma unroll
    for (int m = 0; m < kMaxItems; ++m) acc[m] = 0.0f;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      if (n_chunks > 1) stage_chunk(a, stage, chunk);
      tcsdn::cp_async_wait_all();
      __syncthreads();  // the chunk and the X tile are in shared memory
      const int nt = min(a.trees_per_chunk, a.n_trees - chunk * a.trees_per_chunk);

      // phase 1: warp item (tree, group of 32 rows), lane = row
      for (int it = warp; it < nt * groups; it += kWarps) {
        const int tl = it / groups;
        const int r = (it - tl * groups) * 32 + lane;
        const uint2* rec = reinterpret_cast<const uint2*>(stage + tl * a.blob_words);
        slots[tl * R + r] = static_cast<uint16_t>(walk(rec, D, xt + r * xs, 1) - D);
      }
      __syncthreads();  // every slot of the chunk is written

      // phase 2: item (row, class), the chunk's trees in order
#pragma unroll
      for (int m = 0; m < kMaxItems; ++m) {
        const int i = t + m * kMaxThreads;
        if (i < items) {
          const int r = i / C;
          const float* lv =
              reinterpret_cast<const float*>(stage) + a.node_words + (i - r * C);
          float s = acc[m];
#pragma unroll 8
          for (int tl = 0; tl < nt; ++tl) {
            s = __fadd_rn(s, lv[tl * a.blob_words + slots[tl * R + r] * C]);
          }
          acc[m] = s;
        }
      }
      __syncthreads();  // the stage, the X tile and the slots are free
    }

#pragma unroll
    for (int m = 0; m < kMaxItems; ++m) {
      const int i = t + m * kMaxThreads;
      if (i < items && row0 + i / C < a.n_rows) {
        a.out[static_cast<size_t>(row0) * C + i] = acc[m];
      }
    }
  }
}

__device__ __forceinline__ void add_leaf(float* acc, const unsigned* blob,
                                         int node_words, unsigned slot,
                                         int C) {
  const float* lv = reinterpret_cast<const float*>(blob) + node_words + slot * C;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    if (c < C) acc[c] = __fadd_rn(acc[c], lv[c]);
  }
}

__device__ void row_design(const Args& a, unsigned char* smem) {
  const int R = blockDim.x;  // rows per tile, a thread each
  unsigned* stage = reinterpret_cast<unsigned*>(smem);
  float* xt = reinterpret_cast<float*>(
      smem + static_cast<size_t>(a.trees_per_chunk) * a.blob_words * 4);
  const unsigned D = static_cast<unsigned>(a.n_internal);
  const int C = a.n_classes;
  const int t = threadIdx.x;
  const float* x = xt + t;  // this thread's column of the [feature][row] tile
  const int n_tiles = (a.n_rows + R - 1) / R;
  const int n_chunks = (a.n_trees + a.trees_per_chunk - 1) / a.trees_per_chunk;

  if (n_chunks == 1) {  // kept for every tile
    stage_chunk(a, stage, 0);
    tcsdn::cp_async_wait_all();
    __syncthreads();
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * R + t;
    stage_row(a, row, xt + t, R);  // read by this thread alone
    float acc[kMaxClasses];
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) acc[c] = 0.0f;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      if (n_chunks > 1) {
        __syncthreads();  // every thread is done with the previous chunk
        stage_chunk(a, stage, chunk);
        tcsdn::cp_async_wait_all();
        __syncthreads();
      }
      if (row >= a.n_rows) continue;
      const int nt = min(a.trees_per_chunk, a.n_trees - chunk * a.trees_per_chunk);
      for (int tl = 0; tl < nt; ++tl) {
        const unsigned* b = stage + tl * a.blob_words;
        add_leaf(acc, b, a.node_words,
                 walk(reinterpret_cast<const uint2*>(b), D, x, R) - D, C);
      }
    }
    if (row < a.n_rows) {
      float* o = a.out + static_cast<size_t>(row) * C;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < C) o[c] = acc[c];
      }
    }
  }
}

// kRowPerThread: the row design; else the tile design.
template <bool kRowPerThread>
__global__ void __launch_bounds__(kMaxThreads, 1) forest_proba_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kRowPerThread) {
    row_design(a, smem);
  } else {
    tile_design(a, smem);
  }
}

template <bool kRowPerThread>
int launch(const Args& a, int blocks, int threads, size_t smem,
           cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(
      forest_proba_kernel<kRowPerThread>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  forest_proba_kernel<kRowPerThread><<<blocks, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `forest` must be 16-byte aligned. Requires
// 1 <= n_features <= 64, 1 <= n_classes <= 16, n_internal + n_leaves <
// 2^13, blob_words a multiple of 4, and rows_per_tile a multiple of 32:
// 32-128 for the tile design (blocks of 1024 threads), 256-1024 for the
// row design (blocks of rows_per_tile threads). The stage of
// trees_per_chunk blobs, the X tile and (tile design) the 2-byte slots
// must fit kSmemBytes of shared memory.
extern "C" int forest_proba_launch(
    const void* X, int n_rows, int n_features,
    const void* forest, int n_trees, int n_internal,
    int n_leaves, int node_words, int blob_words, int n_classes,
    int rows_per_tile, int trees_per_chunk, int blocks,
    void* out, void* stream) {
  const bool rows = rows_per_tile > kMaxTileRows;
  if (n_rows < 0 || n_features < 1 || n_features > kMaxFeatures ||
      n_classes < 1 || n_classes > kMaxClasses || n_trees < 1 ||
      n_internal < 1 || n_leaves < 1 ||
      n_internal + n_leaves > static_cast<int>(kChildMask) ||
      node_words < 2 * n_internal || blob_words % 4 != 0 ||
      blob_words < node_words + n_leaves * n_classes ||
      rows_per_tile < 32 || rows_per_tile > kMaxThreads ||
      rows_per_tile % 32 != 0 || (rows && rows_per_tile < 256) ||
      trees_per_chunk < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int per_chunk = trees_per_chunk < n_trees ? trees_per_chunk : n_trees;
  size_t smem = static_cast<size_t>(per_chunk) * blob_words * 4;
  if (rows) {
    smem += static_cast<size_t>(rows_per_tile) * n_features * 4;
  } else {
    smem += static_cast<size_t>(rows_per_tile) * (n_features | 1) * 4 +
            static_cast<size_t>(per_chunk) * rows_per_tile * 2;
  }
  if (smem > static_cast<size_t>(kSmemBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(X), n_rows, n_features,
               static_cast<const int4*>(forest), n_trees, n_internal,
               node_words, blob_words, n_classes, rows_per_tile, per_chunk,
               static_cast<float*>(out)};
  const auto s = static_cast<cudaStream_t>(stream);
  return rows ? launch<true>(a, blocks, rows_per_tile, smem, s)
              : launch<false>(a, blocks, kMaxThreads, smem, s);
}
