// Cold-tier scatter-add kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pallas_cold_tier`
// (experiments/cold_tier_bench.py:42, call :90), the fused design of the
// cold stage of tiered scoring (`do_tier` in tpu_ir/ops/scoring.py:343-353).
// For one df tier of the tiered sparse layout (tdocs/ttfs [V_t, P_t]) it
// computes, in place on a float32 [B, D+1] score accumulator,
//
//     for b, for l = 0..L-1 with q_tier[b, l] == tier and w[b, l] != 0,
//       r = row[b, l] clamped into 0..V_t-1:
//       for every slot p with tf = ttfs[r, p] > 0 and doc = tdocs[r, p] <= D:
//         scores[b, doc] += cell(tf, doc) * w[b, l]
//
// where cell is 1 + ln tf (TF-IDF) or the BM25 saturation
// tf*(k1+1) / max(tf + k1*dl_norm[doc], 1e-9). q_tier, row and w are a
// query block's per-term arrays, shared by every tier's launch; a term
// outside this tier weighs 0, as in the Pallas kernel, and the clamp is
// the JAX gather's. The doc <= D test is the JAX scatter's mode="drop".
//
// Bound on an H100: memory. Each in-tier (b, l) with w != 0 reads its row,
// P_t * 8 bytes of docs and tfs; each posting with tf > 0 reads and writes
// one 4-byte score (8 bytes), and BM25 reads 4 more of dl_norm. The
// arithmetic is a few flops per 8-12 bytes, far below the card's ridge
// point. The design reads each needed row once, skips zero-weight terms and
// touches only the score cells the postings name, with no [B, L, P_t]
// intermediate in device memory (the XLA path writes and re-reads one). Score
// cells are scattered (random docs), so each touch costs a 32-byte sector;
// the cap-2 tier leaves most threads of a block idle. Both are later work.
//
// Design: the TPU kernel walks a sequential (B, L) grid and keeps query b's
// score row in VMEM. The row is 400 KB at 100,000 docs, more than a block's
// shared memory, so here it stays in device memory. One block per query row
// b loops l in order; its threads stride over the P_t slots of row r. Within
// one (b, l) the docs of a tier row are distinct, so no two threads write one
// cell; __syncthreads() between terms orders the adds when a later term hits
// the same doc. There is no atomicAdd: every cell is summed in tier order,
// then l order, the same order on every run, so the kernel is bitwise equal
// to its plain PyTorch twin (ops/cold_tier.py).
//
// Rounding: the round-to-nearest intrinsics keep nvcc from contracting a
// multiply and an add into an FMA, and logf (never __logf, never
// --use_fast_math) rounds as torch.log does on the card. Offsets are 64-bit:
// b * (D+1) reaches 2.5e8 within a block of queries at 100,000 docs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;

template <bool kBm25>
__global__ void __launch_bounds__(kMaxThreads)
cold_tier_kernel(const int32_t* __restrict__ q_tier,
                 const int32_t* __restrict__ rows,
                 const float* __restrict__ weights,
                 const int32_t* __restrict__ tdocs,
                 const int32_t* __restrict__ ttfs,
                 const float* __restrict__ dl_norm,
                 float* __restrict__ scores, int32_t tier,
                 int64_t num_terms, int64_t num_rows, int64_t cap,
                 int64_t width, float k1, float k1_plus_1) {
  const int64_t b = blockIdx.x;
  const int64_t num_docs = width - 1;
  float* q_scores = scores + b * width;
  for (int64_t l = 0; l < num_terms; ++l) {
    const int64_t i = b * num_terms + l;
    const float w = q_tier[i] == tier ? weights[i] : 0.0f;
    if (w != 0.0f) {                       // uniform across the block
      const int64_t row = rows[i];
      const int64_t r = row < 0 ? 0 : (row < num_rows ? row : num_rows - 1);
      const int32_t* row_docs = tdocs + r * cap;
      const int32_t* row_tfs = ttfs + r * cap;
      for (int64_t p = threadIdx.x; p < cap; p += blockDim.x) {
        const int32_t tf = row_tfs[p];
        const int32_t doc = row_docs[p];
        if (tf > 0 && doc >= 0 && doc <= num_docs) {
          const float tff = static_cast<float>(tf);
          float cell;
          if (kBm25) {
            const float den = fmaxf(
                __fadd_rn(tff, __fmul_rn(k1, dl_norm[doc])), 1e-9f);
            cell = __fdiv_rn(__fmul_rn(tff, k1_plus_1), den);
          } else {
            cell = __fadd_rn(1.0f, logf(tff));
          }
          q_scores[doc] = __fadd_rn(q_scores[doc], __fmul_rn(cell, w));
        }
      }
    }
    __syncthreads();                       // a later term may hit a doc
  }
}

}  // namespace

// q_tier, rows int32 [B, L] (each term's tier, -1 for none, and its row
// there); weights float32 [B, L]; tdocs, ttfs int32 [V_t, cap]; dl_norm
// float32 [width] or null for TF-IDF; scores float32 [B, width],
// accumulated in place. All contiguous on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpu_ir_cold_tier(const void* q_tier, const void* rows,
                                const void* weights, const void* tdocs,
                                const void* ttfs, const void* dl_norm,
                                void* scores, int32_t tier, int64_t batch,
                                int64_t num_terms, int64_t num_rows,
                                int64_t cap, int64_t width, float k1,
                                float k1_plus_1, void* stream) {
  if (batch <= 0 || num_terms <= 0 || num_rows <= 0 || cap <= 0 ||
      width <= 0)
    return 0;
  // one warp at least, one thread per slot up to kMaxThreads
  int64_t threads = (cap + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const auto* qt = static_cast<const int32_t*>(q_tier);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* w = static_cast<const float*>(weights);
  const auto* td = static_cast<const int32_t*>(tdocs);
  const auto* tt = static_cast<const int32_t*>(ttfs);
  const auto* dl = static_cast<const float*>(dl_norm);
  auto* s = static_cast<float*>(scores);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(batch));
  const dim3 block(static_cast<unsigned>(threads));
  if (dl != nullptr) {
    cold_tier_kernel<true><<<grid, block, 0, st>>>(
        qt, r, w, td, tt, dl, s, tier, num_terms, num_rows, cap, width, k1,
        k1_plus_1);
  } else {
    cold_tier_kernel<false><<<grid, block, 0, st>>>(
        qt, r, w, td, tt, dl, s, tier, num_terms, num_rows, cap, width, k1,
        k1_plus_1);
  }
  return static_cast<int>(cudaGetLastError());
}
