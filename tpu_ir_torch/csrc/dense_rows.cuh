// The schedule shared by the two dense score kernels for Hopper (sm_90a):
// dense_score.cu (float32 (1 + ln tf) cells) and dequant_score.cu (bf16
// raw-tf cells). Each of them instantiates `score_items` with its cell type
// and weighting; this file holds the loop nest, the term resolution and
// the launch.
//
//     out[b, d] = sum_l w[b, l] * cell(X[q[b, l], d])
//     w[b, l]   = idf[q[b, l]] if 0 <= q[b, l] < V, else 0
//
// What bounds it: bytes. Each (b, l) with w != 0 reads one [D+1] row of
// X and each query writes one [D+1] float32 score row; the arithmetic per
// cell is a handful of flops against 2 or 4 bytes read, far below the
// card's ridge point. At the reference query load (B = 10,000, L = 2,
// D+1 = 8,762) that is 0.35 GB of scores and 0.35-0.70 GB of rows.
//
// Design. One thread per (query, column) in blocks of 256 columns would
// make 350,000 short blocks at the reference load, each thread with two
// dependent scalar loads in flight and the block prologue paid 350,000
// times: latency, not bytes, would set the time. Here:
//
// - Work items are (query b, column tile). launch() picks the tile width
//   and a grid of about (SMs x kMinBlocks) blocks; each block walks items
//   blockIdx.x, blockIdx.x + gridDim.x, ... A row is cut into tiles of at
//   least kMinTile columns only when the batch alone cannot fill the grid,
//   so at the reference load a tile is the whole row and a block pays its
//   prologue once per query.
// - The block resolves its query's ids into shared memory: threads check
//   0 <= id < V and gather idf[id] (0 otherwise). The wrapper passes the
//   raw ids and the idf vector and launches nothing else. Terms are
//   resolved kStage at a time; a query of up to kStage terms is resolved
//   once per item.
// - A pass covers kThreads * kCols columns from p0: thread t owns columns
//   p0 + t + j * kThreads, j < kCols, so every warp load is one coalesced
//   line and no access needs any alignment (rows of 8,762 cells start on
//   8- or 4-byte boundaries). Terms go in groups of G: all G * kCols loads
//   of a group are issued before the first add, kValues = 32 cells in
//   flight per thread: G = 2 terms of 16 columns for L <= 2 (at L = 1 the
//   dead second term weighs 0 and loads nothing), G = 4 terms of 8
//   columns otherwise.
// - Scores are written with streaming stores (__stcs): they are written
//   once and read once by the top-k, and should not push rows out of L2.
//
// Terms whose weight is 0 (-1 pads, ids outside the vocabulary, df == 0)
// load nothing and add nothing. That leaves the sum's bits alone: the
// plain twin adds w * x = +-0 for those terms, and acc + (+-0) == acc for
// every acc the sum can hold (it starts at +0, and a round-to-nearest sum
// is -0 only if both addends are), as long as the cells are finite, which
// (1 + ln tf) and raw tfs are. Every other term is one rounded multiply and
// one rounded add, in l order, as in the twin: the result is bitwise equal
// to it. The intrinsics keep nvcc from contracting them into an FMA.
// Offsets are 64-bit: row * (D+1) reaches 5e8 at the dense-layout budget.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dense_rows {

constexpr int kThreads = 256;   // threads per block
constexpr int kMinBlocks = 4;   // resident blocks per SM the registers allow
constexpr int kValues = 32;     // cells a thread holds in flight per group
constexpr int kStage = 256;     // terms resolved into shared memory at once
constexpr int kMinTile = 2048;  // the narrowest column tile a row is cut into

// Resolves terms [s0, s0 + n) of one query into (row, weight) pairs.
__device__ inline void resolve(const int32_t* __restrict__ q,
                               const float* __restrict__ idf, int64_t vocab,
                               int64_t s0, int n, int32_t* s_row,
                               float* s_w) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int32_t id = q[s0 + i];
    const bool valid = id >= 0 && id < vocab;
    s_w[i] = valid ? idf[id] : 0.0f;
    s_row[i] = valid ? id : 0;
  }
}

// The body of one dense score kernel. Cell::T is the matrix's cell type
// and Cell::weight(x) the cell's float32 term weight; G terms per group.
template <class Cell, int G>
__device__ __forceinline__ void score_items(
    const int32_t* __restrict__ q, const float* __restrict__ idf,
    const typename Cell::T* __restrict__ matrix, float* __restrict__ out,
    int64_t batch, int64_t num_terms, int64_t vocab, int64_t width,
    int64_t tiles, int64_t tile_width) {
  using T = typename Cell::T;
  constexpr int kCols = kValues / G;
  constexpr int kChunk = kThreads * kCols;
  __shared__ int32_t s_row[kStage];
  __shared__ float s_w[kStage];
  const int t = threadIdx.x;
  const int64_t n_stages = (num_terms + kStage - 1) / kStage;
  const int64_t items = batch * tiles;

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t b = item / tiles;
    // columns fit in 32 bits (launch() checks width), row offsets do not
    const int c_lo = static_cast<int>((item % tiles) * tile_width);
    const int c_hi = static_cast<int>(
        c_lo + tile_width < width ? c_lo + tile_width : width);
    const int32_t* qb = q + b * num_terms;
    float* ob = out + b * width;
    if (n_stages == 1) {
      __syncthreads();                  // the last item's readers are done
      resolve(qb, idf, vocab, 0, static_cast<int>(num_terms), s_row, s_w);
      __syncthreads();
    }
    for (int p0 = c_lo; p0 < c_hi; p0 += kChunk) {  // uniform: it syncs
      const int c0 = p0 + t;
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
      for (int64_t s0 = 0; s0 < num_terms; s0 += kStage) {
        const int n = static_cast<int>(
            num_terms - s0 < kStage ? num_terms - s0 : kStage);
        if (n_stages > 1) {
          __syncthreads();
          resolve(qb, idf, vocab, s0, n, s_row, s_w);
          __syncthreads();
        }
#pragma unroll 1
        for (int g0 = 0; g0 < n; g0 += G) {
          T v[G][kCols];
          float w[G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const bool live = g0 + g < n;
            w[g] = live ? s_w[g0 + g] : 0.0f;
            const T* row =
                matrix + static_cast<int64_t>(live ? s_row[g0 + g] : 0) * width;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              const int c = c0 + j * kThreads;
              v[g][j] = (w[g] != 0.0f && c < c_hi) ? __ldg(row + c) : T(0);
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (w[g] == 0.0f) continue;  // the same for the whole block
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[j] = __fadd_rn(acc[j], __fmul_rn(Cell::weight(v[g][j]),
                                                   w[g]));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + j * kThreads;
        if (c < c_hi) __stcs(ob + c, acc[j]);
      }
    }
  }
}

template <class T>
using Kernel = void (*)(const int32_t*, const float*, const T*, float*,
                        int64_t, int64_t, int64_t, int64_t, int64_t,
                        int64_t);

// The current device's SM count, read once per device.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

// Plans the grid (tiles per row, tile width, blocks) and launches the
// kernel of the query width's group size on `stream`: g2 for L <= 2, g4
// otherwise. Every (query, column) is in exactly one work item and no tile
// is empty. Returns a CUDA error code (0 on success).
template <class T>
int launch(Kernel<T> g2, Kernel<T> g4, const void* q, const void* idf,
           const void* matrix, void* out, int64_t batch, int64_t num_terms,
           int64_t vocab, int64_t width, void* stream) {
  if (batch <= 0 || width <= 0) return 0;
  if (width > 0x7fff0000 || num_terms < 0 || vocab < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t target = static_cast<int64_t>(sm_count()) * kMinBlocks;
  if (target <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t most_tiles = width > kMinTile ? width / kMinTile : 1;
  const int64_t want_tiles = (target + batch - 1) / batch;
  int64_t tiles = want_tiles < most_tiles ? want_tiles : most_tiles;
  const int64_t tile_width = (width + tiles - 1) / tiles;
  tiles = (width + tile_width - 1) / tile_width;   // no empty last tile
  const int64_t items = batch * tiles;
  const int64_t grid = items < target ? items : target;
  const Kernel<T> kernel = num_terms <= 2 ? g2 : g4;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const float*>(idf),
      static_cast<const T*>(matrix), static_cast<float*>(out), batch,
      num_terms, vocab, width, tiles, tile_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dense_rows
