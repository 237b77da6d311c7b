// Dense TF-IDF score kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pallas_tfidf_scores`
// (tpu_ir/ops/pallas_scoring.py:52, kernel `_score_kernel` :35). It computes
//
//     out[b, d] = sum_l w[b, l] * M[row[b, l], d]
//
// over a dense [V, D+1] float32 doc matrix of (1 + ln tf) weights, where
// row[b, l] is query b's l-th term id (already clamped to a valid row by the
// wrapper) and w[b, l] its idf weight (0 for padding and out-of-vocabulary
// ids). Like the Pallas kernel it streams one doc-matrix row per
// (query, term) and writes no [B, L, D+1] intermediate.
//
// Bound on an H100: memory. Each (b, l) reads one (D+1)-float row and each
// query writes one (D+1)-float score row; the arithmetic is 2 flops per
// 4-byte load, some 300 times below the card's ridge point. At the reference
// query load (B = 10,000, L = 2, D+1 = 8,762) that is at most 0.70 GB of rows
// and 0.35 GB of scores: 0.31 ms at 3.35 TB/s (less where queries share rows).
//
// Design: the TPU kernel walks a sequential (B, L) grid and carries the sum
// in VMEM from one step to the next. On Hopper blocks run in parallel and in
// no order, so the term loop moves inside the thread instead: the grid is
// (doc tiles of blockDim.x columns, queries), each thread owns one doc
// column of one query and accumulates its L terms in a register, in l
// order. Neighbouring threads read neighbouring columns of the same row, so
// every warp load is one coalesced 128-byte line. D+1 is not a multiple of
// 4 in general (8,762 at reference scale), so rows are not 16-byte aligned
// and the loads stay scalar; vectorised or TMA row loads are later work.
//
// The product and sum use the round-to-nearest intrinsics so that nvcc
// cannot contract them into an FMA: the kernel is then bitwise equal to the
// plain PyTorch version (a multiply kernel, then an add kernel, per term).
// Offsets are computed in 64 bits: row * (D+1) reaches 2.6e8 at reference
// scale and 5e8 at the dense-layout budget.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
dense_score_kernel(const int32_t* __restrict__ rows,
                   const float* __restrict__ weights,
                   const float* __restrict__ matrix,
                   float* __restrict__ out,
                   int64_t num_terms, int64_t width) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (d >= width) return;
  const int64_t b = blockIdx.y;
  const int32_t* q_rows = rows + b * num_terms;
  const float* q_w = weights + b * num_terms;
  float acc = 0.0f;
  for (int64_t l = 0; l < num_terms; ++l) {
    const int64_t r = q_rows[l];
    acc = __fadd_rn(acc, __fmul_rn(q_w[l], matrix[r * width + d]));
  }
  out[b * width + d] = acc;
}

}  // namespace

// rows: int32 [B, L]; weights: float32 [B, L]; matrix: float32 [V, width];
// out: float32 [B, width]. All contiguous on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpu_ir_dense_score(const void* rows, const void* weights,
                                  const void* matrix, void* out,
                                  int64_t batch, int64_t num_terms,
                                  int64_t width, void* stream) {
  if (batch <= 0 || width <= 0) return 0;
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* w = static_cast<const float*>(weights);
  const auto* m = static_cast<const float*>(matrix);
  auto* o = static_cast<float*>(out);
  const unsigned grid_x =
      static_cast<unsigned>((width + kThreads - 1) / kThreads);
  // gridDim.y is capped at 65,535: larger batches go in slices
  for (int64_t b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int64_t nb = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    dim3 grid(grid_x, static_cast<unsigned>(nb));
    dense_score_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        r + b0 * num_terms, w + b0 * num_terms, m, o + b0 * width,
        num_terms, width);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
