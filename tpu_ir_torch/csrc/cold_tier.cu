// Cold-stage scatter-add kernel for Hopper (sm_90a): every df tier of a
// query block in one launch.
//
// Replaces the Pallas TPU kernel `pallas_cold_tier`
// (experiments/cold_tier_bench.py:42, call :90), the fused design of the
// cold stage of tiered scoring (`do_tier` in tpu_ir/ops/scoring.py:343-353),
// and runs it for all the tiers of the tiered sparse layout at once. Tier t
// holds docs/tfs int32 [V_t, P_t]. In place on a float32 [B, D+1] score
// accumulator it computes
//
//     for b, for t in tier order, for l = 0..L-1 with q_tier[b, l] == t and
//       w[b, l] != 0, r = row[b, l] clamped into 0..V_t-1:
//       for every slot p with tf = tfs_t[r, p] > 0 and
//                                 doc = docs_t[r, p] <= D:
//         scores[b, doc] += cell(tf, doc) * w[b, l]
//
// where cell is 1 + ln tf (TF-IDF) or the BM25 saturation
// tf*(k1+1) / max(tf + k1*dl_norm[doc], 1e-9). A term outside every tier
// (tier -1, or past the table) weighs 0, as in the Pallas kernel; the clamp
// is the JAX gather's; the doc <= D test is the JAX scatter's mode="drop".
// Empty tiers (V_t = 0 or P_t = 0) stay in the table and add nothing.
//
// Bound on an H100: bytes; what holds it far above that bound is the fixed
// cost of a launch and the latency of dependent round trips. Each in-tier
// term with w != 0 reads its row (P_t * 8 bytes of docs and tfs); each
// posting reads and writes one 4-byte score, and BM25 reads 4 bytes of
// dl_norm. At wiki100k a 2,499-query block needs 5.5 MB, 1.65 us at
// 3.35 TB/s: less than the device's fixed cost of one launch, so the stage
// is one launch, not one per tier. The
// score cells are scattered (random docs): each touch moves a 32-byte
// sector, not 4 bytes, and the byte bound counts neither that nor the
// chain each query makes: its term ids, then per term its row, then that
// row's score cells, each a round trip to device memory.
//
// Design. The TPU kernel walks a sequential (B, L) grid and keeps query b's
// score row in VMEM; the row is 400 KB at 100,000 docs, so here it stays in
// device memory. A block of 8 warps takes 8 queries. A query's cold terms
// are at most L (2 at wiki100k), so a warp, not a block, serves one query:
// it finds its terms of each tier with one ballot, skips every other term
// with no barrier, and its lanes stride a term's slots with kInFlight slots
// each in flight (all their tf/doc loads, then all their score loads, then
// the writes), so a row of cap <= 256 (192 for BM25) is one round of round
// trips. A cap-2048 row would take a warp 8 rounds for one term; tiers of
// cap >= kWideCap come last in tier order, so after a block barrier the
// whole block takes each of its queries' terms there in turn, 256 threads a
// row: one round again (two for BM25). Within one term the docs of a tier
// row are distinct, so no two threads write one cell; __syncwarp (or
// __syncthreads in the wide phase) between terms orders the adds when a
// later term hits the same doc. There is no atomicAdd: every cell is summed
// in tier order, then l order, the same order on every run, so the kernel
// is bitwise equal to its plain PyTorch twin (ops/cold_tier.py). The
// schedules tried and dropped (every tier on the warps, the block-wide
// phase from cap 512) are in PERF.md.
//
// The tier table (pointers, rows and caps) is passed by value as a kernel
// parameter: no device allocation and no copy per call.
//
// Rounding: the round-to-nearest intrinsics keep nvcc from contracting a
// multiply and an add into an FMA, and logf (never __logf, never
// --use_fast_math) rounds as torch.log does on the card. The offsets of
// rows are 64-bit: b * (D+1) reaches 2.5e8 within a block of queries at
// 100,000 docs; offsets within a row are 32-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTiers = 16;        // ops/cold_tier.py MAX_TIERS
constexpr int kWarps = 8;            // queries per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;        // per SM: 80 registers a thread,
                                     // 396 blocks (3,168 queries) a wave
// slots a thread has in flight: BM25 keeps a dl_norm value a slot too, and
// at 8 slots its 80 registers spill
template <bool kBm25>
constexpr int kInFlight = kBm25 ? 6 : 8;
constexpr int64_t kWideCap = 2048;   // tiers from here on: block-wide
constexpr unsigned kFullMask = 0xffffffffu;

struct Tier {
  const int32_t* docs;
  const int32_t* tfs;
  int64_t rows;
  int64_t cap;
};

struct Tiers {
  Tier tier[kMaxTiers];
  int32_t count;
  int32_t split;   // tiers [split, count) run block-wide
};

struct Args {
  const int32_t* __restrict__ q_tier;
  const int32_t* __restrict__ rows;
  const float* __restrict__ weights;
  const float* __restrict__ dl_norm;
  float* scores;
  int64_t batch;
  int64_t num_terms;
  int64_t width;
  float k1;
  float k1_plus_1;
};

// Adds one term's row into q_scores: the calling group of threads (a warp
// or the block) strides its slots from `first` by `stride`.
template <bool kBm25>
__device__ __forceinline__ void add_row(const Args& a, const Tier& t,
                                        int64_t row, float w,
                                        float* q_scores, int first,
                                        int stride) {
  constexpr int kIn = kInFlight<kBm25>;
  const int64_t r = row < 0 ? 0 : (row < t.rows ? row : t.rows - 1);
  const int32_t* __restrict__ docs = t.docs + r * t.cap;
  const int32_t* __restrict__ tfs = t.tfs + r * t.cap;
  // 32-bit offsets within a row and a score row (the entry point checks
  // that caps and widths fit): fewer registers for the slots' addresses
  const int cap = static_cast<int>(t.cap);
  const int num_docs = static_cast<int>(a.width - 1);
  for (int p0 = first; p0 < cap; p0 += stride * kIn) {
    int32_t tf[kIn], doc[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const int p = p0 + j * stride;
      tf[j] = p < cap ? __ldg(tfs + p) : 0;
      doc[j] = p < cap ? __ldg(docs + p) : 0;
    }
    float s[kIn], dl[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      if (tf[j] <= 0 || doc[j] > num_docs) doc[j] = -1;   // not added
      s[j] = doc[j] >= 0 ? q_scores[doc[j]] : 0.0f;
      dl[j] = kBm25 && doc[j] >= 0 ? __ldg(a.dl_norm + doc[j]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      if (doc[j] >= 0) {
        const float tff = static_cast<float>(tf[j]);
        float cell;
        if (kBm25) {
          const float den =
              fmaxf(__fadd_rn(tff, __fmul_rn(a.k1, dl[j])), 1e-9f);
          cell = __fdiv_rn(__fmul_rn(tff, a.k1_plus_1), den);
        } else {
          cell = __fadd_rn(1.0f, logf(tff));
        }
        q_scores[doc[j]] = __fadd_rn(s[j], __fmul_rn(cell, w));
      }
    }
  }
}

// Query b's terms of tiers [lo, hi) in (tier, l) order. kBlock: the whole
// block strides each row and every warp walks the same terms; otherwise the
// calling warp alone does.
template <bool kBm25, bool kBlock>
__device__ __forceinline__ void add_terms(const Args& a, const Tiers& tiers,
                                          int64_t b, int32_t lo, int32_t hi) {
  const int lane = threadIdx.x % 32;
  float* q_scores = a.scores + b * a.width;
  for (int32_t t = lo; t < hi; ++t) {
    const Tier& tier = tiers.tier[t];
    if (tier.rows <= 0 || tier.cap <= 0) continue;
    for (int64_t l0 = 0; l0 < a.num_terms; l0 += 32) {
      const int64_t i = b * a.num_terms + l0 + lane;
      const bool in = l0 + lane < a.num_terms && a.q_tier[i] == t &&
                      a.weights[i] != 0.0f;
      for (unsigned m = __ballot_sync(kFullMask, in); m != 0; m &= m - 1) {
        const int64_t j = b * a.num_terms + l0 + __ffs(m) - 1;
        add_row<kBm25>(a, tier, a.rows[j], a.weights[j], q_scores,
                       kBlock ? threadIdx.x : lane, kBlock ? kThreads : 32);
        if (kBlock) {
          __syncthreads();                 // a later term may hit a doc
        } else {
          __syncwarp();
        }
      }
    }
  }
}

// Whether query b has a term with w != 0 in tiers [lo, hi): one warp.
__device__ __forceinline__ bool has_terms(const Args& a, int64_t b,
                                          int32_t lo, int32_t hi) {
  const int lane = threadIdx.x % 32;
  bool any = false;
  for (int64_t l0 = 0; l0 < a.num_terms; l0 += 32) {
    const int64_t i = b * a.num_terms + l0 + lane;
    any |= l0 + lane < a.num_terms && a.q_tier[i] >= lo &&
           a.q_tier[i] < hi && a.weights[i] != 0.0f;
  }
  return __any_sync(kFullMask, any);
}

template <bool kBm25>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cold_tier_kernel(const __grid_constant__ Args a,
                 const __grid_constant__ Tiers tiers) {
  __shared__ bool wide[kWarps];
  const int warp = threadIdx.x / 32;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int64_t b = b0 + warp;                      // uniform in the warp
  if (b < a.batch) add_terms<kBm25, false>(a, tiers, b, 0, tiers.split);
  if (tiers.split == tiers.count) return;           // uniform in the block
  const bool mine = b < a.batch &&
                    has_terms(a, b, tiers.split, tiers.count);
  if (threadIdx.x % 32 == 0) wide[warp] = mine;
  __syncthreads();                         // the narrow tiers come first
  for (int q = 0; q < kWarps; ++q) {
    if (wide[q]) add_terms<kBm25, true>(a, tiers, b0 + q, tiers.split,
                                        tiers.count);
  }
}

}  // namespace

// q_tier, rows int32 [B, L] (each term's tier, -1 for none, and its row
// there); weights float32 [B, L]; tiers: a host int64 [num_tiers, 4] table
// of (docs pointer, tfs pointer, V_t, P_t) per tier, in tier order, each
// tier's docs and tfs int32 [V_t, P_t]; dl_norm float32 [width] or null for
// TF-IDF; scores float32 [B, width], accumulated in place. Device arrays are
// contiguous on the current device. Launches once on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a table
// of more than kMaxTiers tiers, a negative size, or a cap or width past
// 2^30 (in-row offsets are 32-bit).
extern "C" int tpu_ir_cold_tier(const void* q_tier, const void* rows,
                                const void* weights, const void* tiers,
                                int32_t num_tiers, const void* dl_norm,
                                void* scores, int64_t batch,
                                int64_t num_terms, int64_t width, float k1,
                                float k1_plus_1, void* stream) {
  // p0 + stride * kInFlight must stay an int within a row
  constexpr int64_t kMaxInt = INT32_MAX / 2;
  if (num_tiers < 0 || num_tiers > kMaxTiers || batch < 0 ||
      num_terms < 0 || width < 0 || width > kMaxInt)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiers table{};
  const auto* t = static_cast<const int64_t*>(tiers);
  for (int i = 0; i < num_tiers; ++i) {
    if (t[4 * i + 2] < 0 || t[4 * i + 3] < 0 || t[4 * i + 3] > kMaxInt)
      return static_cast<int>(cudaErrorInvalidValue);
    table.tier[i] = {reinterpret_cast<const int32_t*>(t[4 * i]),
                     reinterpret_cast<const int32_t*>(t[4 * i + 1]),
                     t[4 * i + 2], t[4 * i + 3]};
  }
  table.count = num_tiers;
  // the wide phase takes the longest suffix of tiers that are each empty
  // or of cap >= kWideCap, so that tier order holds across the two phases
  table.split = num_tiers;
  while (table.split > 0) {
    const Tier& last = table.tier[table.split - 1];
    if (last.rows > 0 && last.cap > 0 && last.cap < kWideCap) break;
    --table.split;
  }
  if (batch == 0 || num_terms == 0 || width == 0 || num_tiers == 0)
    return 0;
  Args a{static_cast<const int32_t*>(q_tier),
         static_cast<const int32_t*>(rows),
         static_cast<const float*>(weights),
         static_cast<const float*>(dl_norm), static_cast<float*>(scores),
         batch, num_terms, width, k1, k1_plus_1};
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((batch + kWarps - 1) / kWarps));
  if (a.dl_norm != nullptr) {
    cold_tier_kernel<true><<<grid, kThreads, 0, st>>>(a, table);
  } else {
    cold_tier_kernel<false><<<grid, kThreads, 0, st>>>(a, table);
  }
  return static_cast<int>(cudaGetLastError());
}
