// Hot-strip stage of tiered scoring for Hopper (sm_90a).
//
// Replaces the hot-strip product of the JAX package's tiered path:
// `hot_matmul` (tpu_ir/ops/scoring.py:290-304, s + w_hot @ strip, an MXU
// matmul on the TPU) and the block-max pruned branch's product over the
// surviving columns (:582-593). It computes, in place,
//
//     scores[b, c] += P[b, c],   P[b, c] = sum_l w[b, l] * S[r[b, l], c]
//
// over a float32 weighted strip S [H, N] (the whole strip, N = D+1, or
// the columns block-max kept, gathered and weighted). r[b, l] is the
// slot's strip row, or outside 0..H-1 for a slot that adds nothing (-1:
// a cold term or padding). The wrapper folds duplicate hot terms into
// their first slot beforehand, weights summed in slot order, so w is the
// JAX `w_hot` row spread over the query's slots.
//
// The order is fixed: P starts at +0 and adds one rounded product per
// live slot, in slot order (__fmul_rn / __fadd_rn, no FMA contraction),
// then scores gets one rounded add. No cell's sum depends on N, on which
// columns were gathered or on the batch, so block-max == exact holds
// bitwise by construction, and so does one block == many. A query with
// no slot in 0..H-1 is left alone (scores unchanged, not even +0 added);
// a slot whose weight is 0 loads nothing: it would add +-0, which leaves
// the sum's bits alone for the finite, non-negative cells a weighted
// strip holds. The plain twin (ops/hot_stage.py) adds those zeros and
// gives the same bits.
//
// What bounds it: bytes. Each query with a hot slot reads its distinct
// hot rows' N columns (4 bytes a cell) and reads and writes its score row;
// per cell a multiply and an add against 8-12 bytes moved. At the
// wiki100k hot-term load (B = 2,499 queries of one hot term each, N =
// 100,001) that is ~3 GB per block if no row is shared: ~0.9 ms at
// 3.35 TB/s; queries that share a hot row share its bytes in the bound.
// Unlike a GEMM, it never touches the ~98% of [B, H] weights that are 0.
//
// Design: dense_rows.cuh's schedule. Work items are (query, column tile);
// a grid of about SMs x kMinBlocks blocks walks them, cutting rows into
// tiles of at least kMinTile columns only when the batch alone cannot
// fill the grid. A block first asks whether its query holds a hot slot at
// all (one barrier-or; most queries of random traffic hold none and cost
// that read only), then warp 0 compacts the live slots of a stage of
// kStage into shared memory with a ballot, in slot order. A pass covers
// kThreads * kCols columns, thread t owning p0 + t + j * kThreads, so
// every warp load is one coalesced line; a slot's 16 columns are loaded
// before its first add. A query of random traffic holds one hot term, so
// one slot at a time is the common case (two slots of 16 columns in
// flight spilled at the 64 registers four blocks an SM allow).

#include "dense_rows.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kMinBlocks = 4;   // resident blocks per SM
constexpr int kCols = 16;       // columns a thread owns per pass
constexpr int kChunk = kThreads * kCols;
constexpr int kStage = 256;     // slots compacted into shared memory at once
constexpr int kMinTile = 2048;  // the narrowest column tile

// Compacts the live slots (row in 0..num_rows-1, weight != 0) of slots
// [s0, s0 + n) of one query into s_row / s_w in slot order; warp 0 only.
__device__ inline int compact(const int32_t* __restrict__ rb,
                              const float* __restrict__ wb, int64_t s0,
                              int n, int64_t num_rows, int32_t* s_row,
                              float* s_w) {
  const int lane = threadIdx.x;
  int m = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    int32_t r = -1;
    float w = 0.0f;
    if (i < n) {
      r = rb[s0 + i];
      w = wb[s0 + i];
    }
    const bool live = r >= 0 && r < num_rows && w != 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int pos = m + __popc(mask & ((1u << lane) - 1u));
      s_row[pos] = r;
      s_w[pos] = w;
    }
    m += __popc(mask);
  }
  return m;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
hot_stage_kernel(const int32_t* __restrict__ rows,
                 const float* __restrict__ weights,
                 const float* __restrict__ strip, float* __restrict__ scores,
                 int64_t batch, int64_t num_slots, int64_t num_rows,
                 int64_t width, int64_t tiles, int64_t tile_width) {
  __shared__ int32_t s_row[kStage];
  __shared__ float s_w[kStage];
  __shared__ int s_live;
  const int t = threadIdx.x;
  const int64_t n_stages = (num_slots + kStage - 1) / kStage;
  const int64_t items = batch * tiles;

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t b = item / tiles;
    // columns fit in 32 bits (the entry point checks width)
    const int c_lo = static_cast<int>((item % tiles) * tile_width);
    const int c_hi = static_cast<int>(
        c_lo + tile_width < width ? c_lo + tile_width : width);
    const int32_t* rb = rows + b * num_slots;
    const float* wb = weights + b * num_slots;
    float* sb = scores + b * width;

    // a query with no slot in 0..H-1 is left alone; the barrier also
    // keeps this item's staging from overwriting the last item's slots
    int any = 0;
    for (int64_t i = t; i < num_slots; i += kThreads) {
      const int32_t r = rb[i];
      any |= (r >= 0 && r < num_rows);
    }
    if (!__syncthreads_or(any)) continue;

    if (n_stages == 1) {
      if (t < 32) {
        const int m = compact(rb, wb, 0, static_cast<int>(num_slots),
                              num_rows, s_row, s_w);
        if (t == 0) s_live = m;
      }
      __syncthreads();
    }
    for (int p0 = c_lo; p0 < c_hi; p0 += kChunk) {  // uniform: it syncs
      const int c0 = p0 + t;
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
      for (int64_t s0 = 0; s0 < num_slots; s0 += kStage) {
        if (n_stages > 1) {
          __syncthreads();                // the last stage's readers
          if (t < 32) {
            const int n = static_cast<int>(
                num_slots - s0 < kStage ? num_slots - s0 : kStage);
            const int m = compact(rb, wb, s0, n, num_rows, s_row, s_w);
            if (t == 0) s_live = m;
          }
          __syncthreads();
        }
        const int m = s_live;
#pragma unroll 1
        for (int i = 0; i < m; ++i) {
          const float w = s_w[i];
          const float* row = strip + static_cast<int64_t>(s_row[i]) * width;
          float v[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int c = c0 + j * kThreads;
            v[j] = c < c_hi ? __ldg(row + c) : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], w));
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + j * kThreads;
        if (c < c_hi) sb[c] = __fadd_rn(sb[c], acc[j]);
      }
    }
  }
}

}  // namespace

// rows: int32 [B, L] strip rows (-1: adds nothing); weights: float32
// [B, L]; strip: float32 [H, width]; scores: float32 [B, width], updated in
// place. All contiguous on the current device, duplicate rows of a query
// already folded. Plans the grid for the current device, launches on
// `stream` and returns a CUDA error code (0 on success).
extern "C" int tpu_ir_hot_stage(const void* rows, const void* weights,
                                const void* strip, void* scores,
                                int64_t batch, int64_t num_slots,
                                int64_t num_rows, int64_t width,
                                void* stream) {
  if (batch <= 0 || width <= 0 || num_slots <= 0) return 0;
  if (width > 0x7fff0000 || num_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t target =
      static_cast<int64_t>(dense_rows::sm_count()) * kMinBlocks;
  if (target <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t most_tiles = width > kMinTile ? width / kMinTile : 1;
  const int64_t want_tiles = (target + batch - 1) / batch;
  int64_t tiles = want_tiles < most_tiles ? want_tiles : most_tiles;
  const int64_t tile_width = (width + tiles - 1) / tiles;
  tiles = (width + tile_width - 1) / tile_width;   // no empty last tile
  const int64_t items = batch * tiles;
  const int64_t grid = items < target ? items : target;
  hot_stage_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const float*>(weights),
      static_cast<const float*>(strip), static_cast<float*>(scores), batch,
      num_slots, num_rows, width, tiles, tile_width);
  return static_cast<int>(cudaGetLastError());
}
