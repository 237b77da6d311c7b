// Dense TF-IDF score kernel over a bf16 raw-tf matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pallas_tfidf_scores_quantized`
// (tpu_ir/ops/pallas_scoring.py:129, kernel `_dequant_score_kernel` :107).
// It computes
//
//     out[b, d] = sum_l w[b, l] * lntf(T[q[b, l], d])
//     lntf(tf)  = tf > 0 ? 1 + ln(max(tf, 1)) : 0
//
// over a dense [V, D+1] bf16 matrix T of raw term frequencies: the dense
// layout of a compressed (format v3) index. q[b, l] is query b's l-th raw
// term id and w[b, l] = idf[q[b, l]] for a valid id, else 0, resolved
// inside the kernel. Like the Pallas kernel it reads the narrow row, widens
// and weights it in registers, and writes no float32 form of the matrix and
// no [B, L, D+1] intermediate.
//
// Bound on an H100: memory, 2 bytes of row per cell and 4 of scores; the
// arithmetic per cell (a compare, a max, a logf, an add, a multiply and an
// add) is still far below the card's ridge point. At the reference query
// load (B = 10,000, L = 2, D+1 = 8,762, ~13,800 distinct rows) the least
// traffic is 0.24 GB of rows and 0.35 GB of scores: 0.18 ms at 3.35 TB/s,
// against the float32 kernel's 0.25 ms.
//
// The schedule, the term resolution, the skipped zero-weight terms and the
// rounding rules are dense_rows.cuh's, shared with dense_score.cu. Cells
// are read as raw 16-bit patterns and widened by a shift, which is exact
// (a bf16 value is the upper half of the float32 one). logf (never __logf,
// never --use_fast_math) rounds as torch.log does on the card, and
// __fadd_rn/__fmul_rn keep nvcc from contracting to an FMA: the kernel is
// bitwise equal to its plain PyTorch twin (ops/fused_scoring.py) and, on
// tfs that bf16 holds exactly, to dense_score.cu over the float32
// (1 + ln tf) matrix torch computes from the same tfs.

#include "dense_rows.cuh"

namespace {

struct RawTfBf16Cell {
  using T = uint16_t;
  __device__ static float weight(uint16_t bits) {
    const float tf = __uint_as_float(static_cast<uint32_t>(bits) << 16);
    float w = 0.0f;
    if (tf > 0.0f) w = __fadd_rn(1.0f, logf(fmaxf(tf, 1.0f)));
    return w;
  }
};

template <int G>
__global__ void __launch_bounds__(dense_rows::kThreads, dense_rows::kMinBlocks)
dequant_score_kernel(const int32_t* __restrict__ q,
                     const float* __restrict__ idf,
                     const uint16_t* __restrict__ matrix,
                     float* __restrict__ out, int64_t batch,
                     int64_t num_terms, int64_t vocab, int64_t width,
                     int64_t tiles, int64_t tile_width) {
  dense_rows::score_items<RawTfBf16Cell, G>(q, idf, matrix, out, batch,
                                            num_terms, vocab, width, tiles,
                                            tile_width);
}

}  // namespace

// q: int32 [B, L] raw ids; idf: float32 [V]; matrix: bf16 [V, width];
// out: float32 [B, width]. All contiguous on the current device. Plans the
// grid for the current device (dense_rows::launch), launches on `stream`
// and returns a CUDA error code (0 on success).
extern "C" int tpu_ir_dequant_score(const void* q, const void* idf,
                                    const void* matrix, void* out,
                                    int64_t batch, int64_t num_terms,
                                    int64_t vocab, int64_t width,
                                    void* stream) {
  return dense_rows::launch<uint16_t>(dequant_score_kernel<2>,
                                      dequant_score_kernel<4>, q, idf,
                                      matrix, out, batch, num_terms, vocab,
                                      width, stream);
}
