// Dense TF-IDF score kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pallas_tfidf_scores`
// (tpu_ir/ops/pallas_scoring.py:52, kernel `_score_kernel` :35). It computes
//
//     out[b, d] = sum_l w[b, l] * M[q[b, l], d]
//
// over a dense [V, D+1] float32 doc matrix of (1 + ln tf) weights, where
// q[b, l] is query b's l-th raw term id (-1 pads, ids >= V allowed) and
// w[b, l] = idf[q[b, l]] for a valid id, else 0: what the JAX wrapper
// computes outside `pallas_call` (pallas_scoring.py:65-72), resolved here
// inside the kernel. Like the Pallas kernel it streams one doc-matrix row
// per (query, term) and writes no [B, L, D+1] intermediate.
//
// Bound on an H100: memory, 4 bytes of row per cell and 4 of scores. At the
// reference query load (B = 10,000, L = 2, D+1 = 8,762) the batch needs
// ~0.48 GB of distinct rows and 0.35 GB of scores: 0.25 ms at 3.35 TB/s.
//
// The schedule, the term resolution, the skipped zero-weight terms and the
// rounding rules are dense_rows.cuh's, shared with dequant_score.cu. The
// cell is the matrix value itself; each term adds __fmul_rn(x, w) with
// __fadd_rn, so the kernel is bitwise equal to its plain PyTorch twin (a
// multiply kernel, then an add kernel, per term).

#include "dense_rows.cuh"

namespace {

struct LntfCell {
  using T = float;
  __device__ static float weight(float x) { return x; }
};

template <int G>
__global__ void __launch_bounds__(dense_rows::kThreads, dense_rows::kMinBlocks)
dense_score_kernel(const int32_t* __restrict__ q,
                   const float* __restrict__ idf,
                   const float* __restrict__ matrix, float* __restrict__ out,
                   int64_t batch, int64_t num_terms, int64_t vocab,
                   int64_t width, int64_t tiles, int64_t tile_width) {
  dense_rows::score_items<LntfCell, G>(q, idf, matrix, out, batch, num_terms,
                                       vocab, width, tiles, tile_width);
}

}  // namespace

// q: int32 [B, L] raw ids; idf: float32 [V]; matrix: float32 [V, width];
// out: float32 [B, width]. All contiguous on the current device. Plans the
// grid for the current device (dense_rows::launch), launches on `stream`
// and returns a CUDA error code (0 on success).
extern "C" int tpu_ir_dense_score(const void* q, const void* idf,
                                  const void* matrix, void* out,
                                  int64_t batch, int64_t num_terms,
                                  int64_t vocab, int64_t width,
                                  void* stream) {
  return dense_rows::launch<float>(dense_score_kernel<2>,
                                   dense_score_kernel<4>, q, idf, matrix,
                                   out, batch, num_terms, vocab, width,
                                   stream);
}
