// Dense TF-IDF score kernel over a bf16 raw-tf matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pallas_tfidf_scores_quantized`
// (tpu_ir/ops/pallas_scoring.py:129, kernel `_dequant_score_kernel` :107).
// It computes
//
//     out[b, d] = sum_l w[b, l] * lntf(T[row[b, l], d])
//     lntf(tf)  = tf > 0 ? 1 + ln(max(tf, 1)) : 0
//
// over a dense [V, D+1] bf16 matrix T of raw term frequencies: the dense
// layout of a compressed (format v3) index. row[b, l] is query b's l-th term
// id, already clamped to a valid row by the wrapper, and w[b, l] its idf
// weight (0 for padding and out-of-vocabulary ids). Like the Pallas kernel it
// reads the narrow row, widens and weights it on the fly, and writes no
// float32 form of the matrix and no [B, L, D+1] intermediate.
//
// Bound on an H100: memory. Each (b, l) reads one (D+1)-cell row of 2-byte
// bf16 values, half what the float32 kernel (dense_score.cu) reads, and
// each query writes one (D+1)-float score row. The arithmetic per cell is a
// compare, a max, a logf, an add, a multiply and an add: still far below the
// card's ridge point. At the reference query load (B = 10,000, L = 2,
// D+1 = 8,762, ~13,800 distinct rows) the least traffic is 0.24 GB of rows
// and 0.35 GB of scores: 0.18 ms at 3.35 TB/s, against the float32 kernel's
// 0.25 ms.
//
// Design: kernel 1's schedule. The TPU kernel walks a sequential (B, L)
// grid and carries the sum in VMEM; here the grid is (doc tiles of
// blockDim.x columns, queries), each thread owns one doc column of one
// query and accumulates its L terms in a register, in l order. Neighbouring
// threads read neighbouring bf16 cells of one row (64 bytes a warp). Loads
// are scalar; bf16 pairs, wider loads or TMA rows are later work.
//
// Rounding: __bfloat162float is exact; logf (never __logf, never
// --use_fast_math) rounds as torch.log does on the card; the round-to-nearest
// intrinsics keep nvcc from contracting a multiply and an add into an FMA.
// The kernel is then bitwise equal to its plain PyTorch twin
// (ops/fused_scoring.py) and, on tfs that bf16 holds exactly, to
// dense_score.cu over the float32 (1 + ln tf) matrix torch computes from the
// same tfs. Offsets are 64-bit: row * (D+1) reaches 5e8 at the dense-layout
// budget.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
dequant_score_kernel(const int32_t* __restrict__ rows,
                     const float* __restrict__ weights,
                     const __nv_bfloat16* __restrict__ matrix,
                     float* __restrict__ out, int64_t num_terms,
                     int64_t width) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (d >= width) return;
  const int64_t b = blockIdx.y;
  const int32_t* q_rows = rows + b * num_terms;
  const float* q_w = weights + b * num_terms;
  float acc = 0.0f;
  for (int64_t l = 0; l < num_terms; ++l) {
    const int64_t r = q_rows[l];
    const float tf = __bfloat162float(matrix[r * width + d]);
    const float wtf = tf > 0.0f ? __fadd_rn(1.0f, logf(fmaxf(tf, 1.0f)))
                                : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(wtf, q_w[l]));
  }
  out[b * width + d] = acc;
}

}  // namespace

// rows: int32 [B, L]; weights: float32 [B, L]; matrix: bf16 [V, width];
// out: float32 [B, width]. All contiguous on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpu_ir_dequant_score(const void* rows, const void* weights,
                                    const void* matrix, void* out,
                                    int64_t batch, int64_t num_terms,
                                    int64_t width, void* stream) {
  if (batch <= 0 || width <= 0) return 0;
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* w = static_cast<const float*>(weights);
  const auto* m = static_cast<const __nv_bfloat16*>(matrix);
  auto* o = static_cast<float*>(out);
  const unsigned grid_x =
      static_cast<unsigned>((width + kThreads - 1) / kThreads);
  // gridDim.y is capped at 65,535: larger batches go in slices
  for (int64_t b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int64_t nb = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    dim3 grid(grid_x, static_cast<unsigned>(nb));
    dequant_score_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        r + b0 * num_terms, w + b0 * num_terms, m, o + b0 * width,
        num_terms, width);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
