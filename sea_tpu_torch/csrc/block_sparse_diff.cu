// Backward kernels of the differentiable causal fused sparse attention for
// Hopper (sm_90a).
//
// Replaces four TPU kernels of sea_tpu/ops/kernels/block_sparse.py, the
// backward of `fused_sparse_attention` (`_fused_bwd`):
//   * `_causal_kernel_dq`, entry point `sea_causal_dq` (K3, float32 or bf16):
//         dq[r] = Σ_s ds[r, s] · k[s];
//   * `_causal_kernel_dkv`, entry point `sea_causal_dkv` (K4, float32 or
//     bf16):
//         dk[s] = Σ_r ds[r, s] · q[r],   dv[s] = Σ_r p[r, s] · dou[r];
// and the backward of the ring's `ring_fused_train_attention`
// (sea_tpu/parallel/sharded_attention.py), the same sums over one K/V window
// that holds the global columns col_base .. col_base + t_src − 1:
//   * `_causal_kernel_dq_cb` (`dq_window`), entry point `sea_window_dq` (K7):
//     K3 with the window offset on the K/V loads; its tile lists carry
//     global k-block ids, and lse and delta are the rows' totals over all
//     windows, so that the windows' dq contributions sum to K3's dq;
//   * `_causal_kernel_dkv_win` (`dkv_window`), entry point `sea_window_dkv`
//     (K8): K4 over the window's k-tiles, whose grid and transposed lists are
//     window-local (local k-tiles, local q-block ids) while the pixel and
//     causal math, and the skip of sub-tiles that end before the k-tile, use
//     the global column col_base + local column.
// K3 and K4 pass col_base = 0 and their whole K/V.
// with the flash-style recompute, over the alive elements only:
//         p  = exp(q_r · k_s − lse[r])   (0 off the element mask),
//         dp = dou_r · v_s,
//         ds = p · (dp − delta[r]).
// `lse` comes from the forward-with-stats kernel (+inf on rows with no alive
// column, where p is then 0), `dou` = dO · scaler and `delta` = Σ_d dou · o /
// scaler are computed outside the kernels in plain PyTorch, as the JAX
// package does. The element mask is the forward body's (sea_mask.cuh), so
// all three kernels agree on it bit for bit.
//
// What bounds them on this card. As functions: per alive element dq needs
// 6·D FLOPs (q·k, dO·v, ds·k) and dk/dv 8·D (q·k, dO·v, dsᵀ·q, pᵀ·dO),
// against reading q, k, v, dO, the mask bits, lse and delta once and writing
// the gradients once; at the main path's densities (6-12% of the causal
// triangle) the bytes at 3.35 TB/s take longer than those FLOPs at either
// type's peak, so the functions are bound by bytes. The kernels do dense
// work on every visited 64 x 64 sub-tile (the 64 x 64 lists keep nearly the
// whole triangle on these masks), so their time goes to the products, the
// predicate and exp per element, and the reads of each visited sub-tile from
// L2 once per tile of the other side.
//
// Two bodies each, one per element type, on one skeleton. Both walk the same
// lists in the same order and read the same element mask; a sub-tile with no
// alive element adds exact zeros (P = dS = 0), so lists of other block
// sizes, or a shard that never lists it, give the same bits. Deterministic:
// no atomics, no row (dq) or column (dk/dv) split across blocks, every sum
// in a fixed order; two launches are equal bit for bit. exp is 2^x on the
// SFU.
//
// The bf16 bodies on wgmma (`causal_dq_wgmma_kernel`, K3 and K7;
// `causal_dkv_wgmma_kernel`, K4 and K8). The JAX kernels take bf16 operands
// and round P and dS to bf16 before their products; outputs come back in
// q's type. One block of three warpgroups: a producer and two consumers of 64
// rows (dq) or 64 columns (dk/dv) each.
//   * The products on wgmma (bf16 operands, float32 accumulators). dq: S =
//     Q·Kᵀ and dP = dO·Vᵀ shared-shared (m64n64k16, both K-major), then dq
//     += dS·K with dS the register A operand, taken from the S accumulators
//     as they stand (as the forward takes P), and K read MN-major, so one
//     swizzled K tile serves both products. dk/dv computes the transposes
//     directly: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ shared-shared, then dv += Pᵀ·dO and
//     dk += dSᵀ·Q with Pᵀ and dSᵀ from registers and dO and Q read MN-major.
//     No score tile goes through shared memory. P and dS (Pᵀ, dSᵀ) are split
//     into bf16 hi + lo, two wgmmas into the same sum, the lo product first:
//     each product keeps about 2^-16 of its size where one rounding (JAX's)
//     would cost 2^-9, so the gradients track the float32 plain version on
//     the same bf16 operands, rounded once to bf16. This answers mma.sync's
//     share of the tensor cores' rate.
//   * The copies by TMA (sea::tile_map over q, k, v and dO; over the window
//     at K7 and K8), in the swizzled layout the descriptors read
//     (sea::Panels: 128-byte swizzle at D = 64 and 128, 32-byte at 80 in
//     16-column panels). dq: the block's Q, dO and mask words arrive once on
//     their own barrier; 64-column K/V sub-tiles fill a ring of STAGES
//     stages, each completing on an mbarrier and released once both
//     consumers' warps have arrived. dk/dv: the block's K and V arrive once;
//     each stage holds a 64-row Q and dO sub-tile and, by 1-D bulk copies,
//     its rows' lse, delta and mask words. One producer lane walks
//     the union of the two consumers' lists in increasing order (dq: the two
//     q-blocks' `counts`/`idx`; dk/dv: the two k-blocks' transposed
//     `counts_t`/`idx_t`), and tags each stage with each consumer's list
//     entry, -1 where the sub-tile is dead for it (absent from its list; dq:
//     past its rows' causal edge or the window's end; dk/dv: rows that all
//     end before its columns), which it then skips. No consumer thread
//     spends an instruction on a copy, and the next sub-tiles load while
//     this one runs.
//   * 128-wide tiles: each K/V (dq) or Q/dO (dk/dv) sub-tile is read from L2
//     once per 128 rows or columns, not per 64, and the heaviest tiles go
//     first (dq: every head's last q-tile; dk/dv: its first k-tile).
//   * The predicate is one bit test per element against 64-bit alive words
//     (sea::alive_bits: run boundaries by algebra, one pinned evaluation
//     each; the causal edge folded in as each row's last column), built by
//     the consumers. dq: rows are the accumulator's rows, as in the
//     forward: the quad that shares a row builds its word per sub-tile
//     while S and dP run. dk/dv: the accumulator's columns are q rows, so a
//     thread needs 16 rows' words; each quad builds two rows' words over its
//     consumer's 64 columns from the rows' mask words copied into the
//     stage, before Sᵀ and dPᵀ (so that at D = 128 their registers are
//     free) and, at D = 64, under the previous sub-tile's products, and the
//     consumer shares them through shared memory (a named barrier a
//     consumer). Building them in the producer warpgroup's idle warps
//     instead, published on the stage's barrier, ran slower (PERF.md):
//     three or four warps build a stage's 128 words where the consumers'
//     eight share them. This answers the ~20 instructions per element of
//     the per-element predicate that the mma.sync bodies took.
//   * Registers (setmaxnreg): producer 40, consumers 232. dq: dq's
//     accumulator (D / 2 floats a thread), S and dP (32 each) and the
//     previous sub-tile's dS fragments (32), whose product stays in flight
//     while the next sub-tile's S, dP and words are made. dk/dv: at D = 128
//     dk and dv hold 128 floats a thread, Sᵀ and dPᵀ 64 more; each sub-tile
//     makes Sᵀ, then Pᵀ in its registers while dPᵀ runs, then dSᵀ in dPᵀ's,
//     then the four fragment sets one k-step at a time from them, then both
//     products, which stay in flight while the next stage is awaited (at
//     D = 64, where the registers hold both, also while the next Sᵀ and dPᵀ
//     run: `DKV_OVERLAP`). One consumer warpgroup owns 64 whole columns of
//     dk and dv at every width.
//   * Shared memory (bytes, from a 1024-byte aligned base): dq 4·T for the
//     resident Q and dO, STAGES·2·T for K and V, 8192 for the mask words,
//     the barriers and walk tags, and 8·nkb for the lists; dk/dv 4·T for K
//     and V, STAGES·(2·T + 5632) for Q, dO and the rows' lse, delta, mask
//     words and alive words, and 8·nq for the lists; T = 128·D, a 64-row
//     tile. At D = 64, 80 and 128: dq 107656, 132232 and 205960, dk/dv
//     121992, 146568 and 220296, plus the lists; one block an SM.
//   * The tiles need t_dst (dq) or t_src (dk/dv) a multiple of 128: the
//     wrappers pad T to it, and the ring's shards are whole 128-row blocks.
//
// The float32 bodies on wgmma (`causal_dq_f32_wgmma_kernel`, K3 and K7;
// `causal_dkv_f32_wgmma_kernel`, K4 and K8) are the bf16 bodies' skeleton
// (the walk over the union of the consumers' lists, heaviest tiles first,
// the TMA copies on mbarriers, warp specialisation under setmaxnreg, the
// alive words, 2^x, the epilogue) with every product kept to float32's
// accuracy in bf16 wgmmas. wgmma takes TF32 operands K-major only, and dS·K,
// Pᵀ·dO and dSᵀ·Q read their B operand MN-major: split TF32 would need
// transposed hi + lo copies of K, Q and dO, 384 or 320 KiB a block at
// D = 128. bf16 wgmma reads either major, so:
//   * Every operand is three bf16 terms, x = x₁ + x₂ + x₃ with x₁ =
//     bf16_rn(x), x₂ = bf16_rn(x − x₁), x₃ = bf16_rn(x − x₁ − x₂), the
//     subtractions exact (`sea::split3_bf16`): 24 significant bits, 384·D
//     bytes a 64-row tile. A product a·b is six bf16 wgmmas into the float32
//     accumulator, smallest first, a₃b₁, a₂b₂, a₁b₃, a₂b₁, a₁b₂, a₁b₁
//     (`f3::product3_ss`, `f3::product3_rs`): the terms left out, a₂b₃, a₃b₂
//     and a₃b₃, are under 2^-26 of a·b, and what the three terms leave of x
//     is about 2^-27 of it, where split TF32 keeps about 2^-21. XLA on a TPU
//     computes a float32 dot at Precision.HIGHEST the same way, in six bf16
//     passes; at the card's 989 TFLOP/s they cost the tensor time of three
//     TF32 passes at 495.
//   * The shared operands are read as the bf16 bodies read them (Q, K, V,
//     dO K-major for the score products; K, dO and Q MN-major for the
//     gradient products), each term a `sea::Panels` tile, so no operand is
//     transposed. P and dS (Pᵀ and dSᵀ) are the register A operands, split
//     from the accumulators as they stand into three fragment sets.
//   * Every operand lands raw by TMA (`sea::f32_map`) in its own place and
//     is split there, on the chip, by the producer warps that issue no copy.
//     `Panels` has twice the columns of a float32 `TPanels` panel and the
//     same rows, so each bf16 panel's two raw panels land where its first
//     and second terms go (`f3::load_raw`); a row's split then reads and
//     writes only that row's lines and the third term's, and the lanes that
//     take a row need no more than a __syncwarp between their reads and
//     their writes (`f3::split3_tile`). No landing slot: each operand's copy
//     is in flight as soon as its place is released. Warp 0's lane 0 walks
//     the lists and issues the copies: the resident operands (dq: Q and dO,
//     with the block's rows' mask words; dk/dv: K and V) at once, then per
//     stage its walk tag, its early operand (dq: V, read by dP alone and
//     released once dP has completed; dk/dv: dO with its rows' lse, delta
//     and mask words, released once dv += Pᵀ·dO has completed) and its late
//     one (dq: K, read by S and dq += dS·K; dk/dv: Q). Each has barriers of
//     its own (landed, split, released), so that the early one is refilled
//     while the late one is still read, and each sub-tile issues its early
//     product first, under which the late operand lands and is split.
//   * Shared memory by width (`f3::Config`, `f3::Layout`): at D = 64 two
//     consumer warpgroups (128 rows or columns) and two stages, dq 204944
//     and dk/dv 208016 bytes; at 80 one and two (two and one left the
//     heaviest 128-row blocks of a short T on the critical path), 188560
//     and 194704; at 128 one and one, 200784 and 202320; each plus 1024 for
//     the base's alignment. The lists are read from global memory by the
//     walking lane.
//   * The alive words are built as in the bf16 bodies, by the consumers
//     under their early product, from the mask words that TMA brought in
//     (dq: the block's rows', once; dk/dv: each stage's rows'). Built by the
//     splitter warps instead, issued after both score products, or with dP
//     issued ahead of the previous dq product's completion, they measured
//     slower (PERF.md §6).
//   * Registers: two producer warpgroups (seven splitter warps) beside two
//     consumers (512 threads) or one (384); setmaxnreg 48 and 208, or 48
//     and 248. A consumer's products complete before the next sub-tile's are
//     issued (the previous gradient product runs while the next stage is
//     awaited); dk/dv completes dv += Pᵀ·dO before it splits dSᵀ, so that at
//     D = 128 dk and dv (128 floats), one product's fragment sets (48) and
//     the other's accumulator fit at once.
//   * The tiles need t_dst (dq) or t_src (dk/dv) a multiple of the block's
//     64 or 128 rows or columns: the wrappers pad T to 128, and the ring's
//     shards are whole 128-row blocks.
//
// Head widths: K3 and K4 are built at D = 64, 80 (OPT-2.7b) and 128
// (LLaMA-7b and 13b) in both types and pick the instance by head_dim at
// launch (`sea::dispatch` over sea::TRAIN_WIDTHS); K7 and K8 take 64 only
// (sea::BASE_WIDTHS).

#include <type_traits>

#include "sea_mask.cuh"
#include "sea_mma.cuh"

namespace {

using sea::bad_geometry;
using sea::bad_window;
using sea::exp2_sfu;
using sea::LOG2E;
using sea::MAX_DEVICES;
using sea::MAX_WORDS;
using sea::misaligned;
using sea::split_bf16;

// ---------------------------------------------------------------------------
// The bf16 bodies on wgmma (K3, K4, K7, K8 in bfloat16)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int STAGES = 4;           // sub-tiles in flight
constexpr int CONSUMERS = 2;        // warpgroups of 64 rows (dq) or columns (dk/dv)
constexpr int BLOCK = 64 * CONSUMERS;  // a block's rows (dq) or columns (dk/dv)
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_MAX = 232448;    // what a block may take on the H100
// setmaxnreg: 128·producer + 256·consumer = 64512, the launch's 168 a thread
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// dk/dv: at D = 64 a consumer holds dk and dv (64 floats a thread), a
// sub-tile's Pᵀ and dSᵀ fragments (64) and the next sub-tile's Sᵀ and dPᵀ
// (64) at once, so the products stay in flight under the next Sᵀ and dPᵀ;
// at 80 and 128 (dk and dv 80 and 128 floats) they complete first.
template <int D>
constexpr bool DKV_OVERLAP = D == 64;

// dq's shared memory from the 1024-byte aligned base: Q and dO (a 64-row
// tile per consumer each), the STAGES K/V stages (K then V), the block's
// mask words, the barriers, each stage's walk tag (c0 and each consumer's
// list entry, -1 where the sub-tile is dead for it), then the two
// consumers' lists, sized at launch.
template <int D>
struct DqLayout {
  using P = sea::Panels<D>;
  static constexpr int DO_OFF = CONSUMERS * P::TILE;
  static constexpr int STAGE_OFF = 2 * CONSUMERS * P::TILE;
  static constexpr int STAGE = 2 * P::TILE;
  static constexpr int WORDS_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int BAR_OFF = WORDS_OFF + BLOCK * MAX_WORDS * 4;
  static constexpr int META_OFF = BAR_OFF + 8 * (2 * STAGES + 1);
  static constexpr int LIST_OFF = META_OFF + 16 * STAGES;
  static constexpr int FIXED = LIST_OFF + 1024;  // and the base's alignment
};

// dk/dv's: K and V (a 64-row tile per consumer each), the STAGES Q/dO
// stages (Q then dO), each stage's rows (lse and delta of its 64 rows and
// their packed mask words, copied in with Q and dO; then each consumer's 64
// alive words, row by row, built by that consumer), the barriers, the walk
// tags (r0 and each consumer's list entry), then the two consumers'
// transposed lists.
template <int D>
struct DkvLayout {
  using P = sea::Panels<D>;
  static constexpr int V_OFF = CONSUMERS * P::TILE;
  static constexpr int STAGE_OFF = 2 * CONSUMERS * P::TILE;
  static constexpr int STAGE = 2 * P::TILE;
  static constexpr int ROWS_OFF = STAGE_OFF + STAGES * STAGE;
  // offsets in a stage's rows
  static constexpr int DELTA = 4 * 64, MASK = 8 * 64, WORDS = MASK + 64 * MAX_WORDS * 4;
  static constexpr int ROWS = WORDS + 8 * 64 * CONSUMERS;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * ROWS;
  static constexpr int META_OFF = BAR_OFF + 8 * (2 * STAGES + 1);
  static constexpr int LIST_OFF = META_OFF + 16 * STAGES;
  static constexpr int FIXED = LIST_OFF + 1024;
};

// One consumer's walk over its list, staged in shared memory: entry e, the
// sub-tile at `pos` (dq: its first column; dk/dv: its first local row), the
// list's length, and where the consumer's own part ends (dq: the first
// column past its rows' causal edge) or starts (dk/dv: its first global
// column).
struct Walk {
  int e, pos, cnt, edge;
  const int* lst;
};

// dq: advance w to the first visited sub-tile at or after (e, pos); false
// when the list is done. The lists are in increasing order, so the first
// sub-tile past the causal edge or the window's end ends the walk.
__device__ __forceinline__ bool seek_cols(Walk& w, int block_k, int col_stop) {
  for (; w.e < w.cnt; ++w.e, w.pos = -1) {
    const int start = w.lst[w.e] * block_k;
    w.pos = w.pos < start ? start : w.pos;
    if (w.pos >= w.edge || w.pos >= col_stop) break;
    if (w.pos < start + block_k) return true;
  }
  w.e = w.cnt;
  return false;
}

// The global row of local row r.
__device__ __forceinline__ int global_row(const int* rowbase, int r, int block_q) {
  return __ldg(rowbase + r / block_q) + r % block_q;
}

// dk/dv: the same over a transposed list, skipping sub-tiles whose rows all
// end before the consumer's columns.
__device__ __forceinline__ bool seek_rows(Walk& w, int block_q, const int* rowbase) {
  for (; w.e < w.cnt; ++w.e, w.pos = -1) {
    const int start = w.lst[w.e] * block_q;
    for (w.pos = w.pos < start ? start : w.pos; w.pos < start + block_q; w.pos += 64)
      if (global_row(rowbase, w.pos, block_q) + 63 >= w.edge) return true;
  }
  return false;
}

// The next stage of the union of the two consumers' walks, in increasing
// order: tag = (its sub-tile, each walk's entry or -1 where the sub-tile is
// not in that walk), the walks advanced past it; false when both are done.
template <typename Seek>
__device__ __forceinline__ bool next(Walk (&w)[2], bool (&have)[2], int (&tag)[3], Seek seek) {
  if (!have[0] && !have[1]) return false;
  tag[0] = !have[1] || (have[0] && w[0].pos <= w[1].pos) ? w[0].pos : w[1].pos;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tag[1 + i] = have[i] && w[i].pos == tag[0] ? w[i].e : -1;
    if (tag[1 + i] >= 0) {
      w[i].pos += 64;
      have[i] = seek(w[i]);
    }
  }
  return true;
}

// One bf16 value pair of a float32 accumulator row into `o`.
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* o, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace wg

// K3 and K7 in bf16: dq of 128 query rows, a consumer warpgroup of 64 each.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1) causal_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const uint32_t* __restrict__ mbits, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts,
    const int* __restrict__ idx, const int* __restrict__ rowbase,
    __nv_bfloat16* __restrict__ dq, int t_dst, int t_src, int t_m, int n_words, int block_q,
    int block_k, int nq, int nkb, int col_base) {
  using L = wg::DqLayout<D>;
  using Pn = sea::Panels<D>;
  constexpr int STAGES = wg::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sea::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR_OFF;   // stage s landed: full + 8·s
  const uint32_t empty = full + 8 * STAGES;  // stage s released by both consumers
  const uint32_t qbar = empty + 8 * STAGES;  // Q, dO and the mask words landed
  int* meta = reinterpret_cast<int*>(smem + L::META_OFF);
  int* lists = reinterpret_cast<int*>(smem + L::LIST_OFF);

  // blocks start with every head's last (heaviest causal) q-tile
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * wg::BLOCK;  // first local row
  const int tid = threadIdx.x;
  // k and v hold the (global) columns col_base .. col_stop − 1
  const int col_stop = col_base + t_src;
  // consumer w's q-block and first global row
  auto qblock = [&](int w) { return (row0 + 64 * w) / block_q; };
  auto first_row = [&](int w) { return rowbase[qblock(w)] + (row0 + 64 * w - qblock(w) * block_q); };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sea::mbar_init(full + 8 * s, 1);
      sea::mbar_init(empty + 8 * s, 4 * wg::CONSUMERS);  // one arrival per consumer warp
    }
    sea::mbar_init(qbar, 1);
    sea::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // The producer warpgroup. Lane 0 of warp 0 issues every copy, warp 0
    // stages the lists first; the other warps leave.
    sea::setmaxnreg_dec<wg::PRODUCER_REGS>();
    if (tid >= 32) return;
    if (tid == 0) {
      sea::mbar_arrive_expect_tx(qbar, 2 * wg::CONSUMERS * Pn::TILE + wg::BLOCK * n_words * 4);
      for (int w = 0; w < wg::CONSUMERS; ++w)
        for (int p = 0; p < Pn::NP; ++p) {
          const int row = bh * t_dst + row0 + 64 * w;
          sea::tma_load_2d(base + w * Pn::TILE + p * Pn::PANEL, &tq, qbar, p * Pn::PW, row);
          sea::tma_load_2d(base + L::DO_OFF + w * Pn::TILE + p * Pn::PANEL, &tdo, qbar,
                           p * Pn::PW, row);
        }
      sea::bulk_load(base + L::WORDS_OFF, mbits + ((long)bh * t_dst + row0) * n_words,
                     wg::BLOCK * n_words * 4, qbar);
    }
    for (int w = 0; w < wg::CONSUMERS; ++w) {
      const long off = ((long)bh * nq + qblock(w)) * nkb;
      const int cnt = counts[bh * nq + qblock(w)];
      for (int i = tid; i < cnt; i += 32) lists[w * nkb + i] = idx[off + i];
    }
    __syncwarp();
    if (tid != 0) return;
    // The walk: the union of the two consumers' sub-tiles in increasing
    // order, each stage tagged with each consumer's list entry.
    auto seek = [&](wg::Walk& x) { return wg::seek_cols(x, block_k, col_stop); };
    wg::Walk w[2];
    bool have[2];
    for (int i = 0; i < 2; ++i) {
      w[i] = wg::Walk{0, -1, counts[bh * nq + qblock(i)], first_row(i) + 64, lists + i * nkb};
      have[i] = seek(w[i]);
    }
    for (int it = 0;; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) sea::mbar_wait(empty + 8 * st, ((it / STAGES) + 1) & 1);
      int* m = meta + 4 * st;
      int tag[3];
      if (!wg::next(w, have, tag, seek)) {
        m[0] = -1;
        sea::mbar_arrive(full + 8 * st);
        break;
      }
      for (int i = 0; i < 3; ++i) m[i] = tag[i];
      sea::mbar_arrive_expect_tx(full + 8 * st, L::STAGE);
      const uint32_t ks = base + L::STAGE_OFF + st * L::STAGE;
      const int krow = bh * t_src + tag[0] - col_base;
      for (int p = 0; p < Pn::NP; ++p) {
        sea::tma_load_2d(ks + p * Pn::PANEL, &tk, full + 8 * st, p * Pn::PW, krow);
        sea::tma_load_2d(ks + Pn::TILE + p * Pn::PANEL, &tv, full + 8 * st, p * Pn::PW, krow);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, 16 a warp; a thread holds rows g
  // and g + 8 of its warp's (h = 0, 1) and, of each, the columns 8·j +
  // 2·t4 + {0, 1} of every accumulator.
  sea::setmaxnreg_inc<wg::CONSUMER_REGS>();
  const int cw = tid / 128 - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lrow0 = row0 + 64 * cw;  // the consumer's first local row
  const int grow0 = first_row(cw);
  const uint32_t* Ms = reinterpret_cast<const uint32_t*>(smem + L::WORDS_OFF);

  // per row h: lse·log2 e, delta, and what its alive words need
  float l2[2], dl[2];
  sea::AliveRow rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 16 * warp + g + 8 * h;
    const int r = grow0 + rl;
    const long gr = (long)bh * t_dst + lrow0 + rl;
    l2[h] = __fmul_rn(lse[gr], LOG2E);
    dl[h] = delta[gr];
    const float wf = (float)(r + 1);
    rows[h] = sea::AliveRow{Ms + (64 * cw + rl) * n_words, r, wf, sea::recip(wf),
                            __fdiv_rn((float)t_m, wf), __fdiv_rn(wf, (float)t_m)};
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t qs = base + cw * Pn::TILE, os = base + L::DO_OFF + cw * Pn::TILE;

  // dq += dS·K of one sub-tile stays in flight while the next one's S, dP
  // and alive words are made: `pending` is its stage, released once it has
  // completed, and fh, fl are its A fragments (dS hi and lo), kept until then
  uint32_t fh[4][4], fl[4][4];
  int pending = -1;

  sea::mbar_wait(qbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    sea::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    const int c0 = meta[4 * st];
    if (c0 < 0) break;
    const int e = meta[4 * st + 1 + cw];
    // a sub-tile not in this consumer's walk adds nothing to its rows: skipped
    if (e < 0) {
      sea::wgmma_wait<0>();
      sea::fence_regs(acc);
      sea::fence_frags(fh);
      sea::fence_frags(fl);
      __syncwarp();
      if (lane == 0) {
        if (pending >= 0) sea::mbar_arrive(empty + 8 * pending);
        sea::mbar_arrive(empty + 8 * st);
      }
      pending = -1;
      continue;
    }
    const uint32_t ks = base + L::STAGE_OFF + st * L::STAGE, vs = ks + Pn::TILE;
    // S = Q·Kᵀ, then dP = dO·Vᵀ, issued; the rows' alive words are built
    // while they (and the previous dq product) run
    float s[32], dp[32];
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sea::wgmma_ss_n64(s, Pn::kdesc(qs, kk), Pn::kdesc(ks, kk), kk > 0);
    sea::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sea::wgmma_ss_n64(dp, Pn::kdesc(os, kk), Pn::kdesc(vs, kk), kk > 0);
    sea::wgmma_commit();
    uint64_t bits[2];
    sea::alive_bits<false, false>(rows, c0, t_m, 0, n_words - 1, t4, bits);
    // S, and the previous dq product, have completed: its stage is released
    sea::wgmma_wait<1>();
    sea::fence_regs(s);
    sea::fence_regs(acc);
    sea::fence_frags(fh);
    sea::fence_frags(fl);
    __syncwarp();
    if (lane == 0 && pending >= 0) sea::mbar_arrive(empty + 8 * pending);

    // P by one bit test per element: element j of row h is s[4·(j / 2) +
    // 2·h + j % 2], column c0 + 8·(j / 2) + 2·t4 + j % 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t a = bits[h] >> (2 * t4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float& x = s[4 * (j >> 1) + 2 * h + (j & 1)];
        x = (a >> (8 * (j >> 1) + (j & 1))) & 1u ? exp2_sfu(__fmaf_rn(x, LOG2E, -l2[h])) : 0.f;
      }
    }
    // dS = P·(dP − delta) in place of P
    sea::wgmma_wait<0>();
    sea::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
    // dS = dS_hi + dS_lo in bf16, the A fragments straight from the
    // accumulators
#pragma unroll
    for (int i = 0; i < 16; ++i) split_bf16(s[2 * i], s[2 * i + 1], fh[i / 4][i % 4], fl[i / 4][i % 4]);

    // dq += dS·K, two wgmmas per 16 columns (lo first), left in flight
    sea::fence_regs(acc);
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t kd = Pn::mndesc(ks, kk);
      sea::wgmma_rs<D>(acc, fl[kk], kd);
      sea::wgmma_rs<D>(acc, fh[kk], kd);
    }
    sea::wgmma_commit();
    pending = st;
  }
  sea::wgmma_wait<0>();
  sea::fence_regs(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* o = dq + ((long)bh * t_dst + lrow0 + 16 * warp + g + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) wg::store_bf16x2(o + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// K4 and K8 in bf16: dk and dv of 128 key columns, a consumer warpgroup of 64
// each.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1) causal_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const uint32_t* __restrict__ mbits, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts_t,
    const int* __restrict__ idx_t, const int* __restrict__ rowbase,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t_dst, int t_src,
    int t_m, int n_words, int block_q, int block_k, int nq, int nkb, int col_base) {
  using L = wg::DkvLayout<D>;
  using Pn = sea::Panels<D>;
  constexpr int STAGES = wg::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sea::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR_OFF;   // stage s landed: full + 8·s
  const uint32_t empty = full + 8 * STAGES;  // stage s released by both consumers
  const uint32_t kvbar = empty + 8 * STAGES;  // K and V landed
  int* meta = reinterpret_cast<int*>(smem + L::META_OFF);
  int* lists = reinterpret_cast<int*>(smem + L::LIST_OFF);

  // blocks start with every head's first (heaviest causal) k-tile
  const int bh = blockIdx.x;
  const int col0 = blockIdx.y * wg::BLOCK;  // first local column of the block
  const int tid = threadIdx.x;
  // consumer w's k-block of the transposed lists, and its first global column
  auto kblock = [&](int w) { return (col0 + 64 * w) / block_k; };
  auto gcol = [&](int w) { return col_base + col0 + 64 * w; };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sea::mbar_init(full + 8 * s, 1);
      sea::mbar_init(empty + 8 * s, 4 * wg::CONSUMERS);  // one arrival per consumer warp
    }
    sea::mbar_init(kvbar, 1);
    sea::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // The producer warpgroup. Lane 0 of warp 0 issues every copy, warp 0
    // stages the lists first; the other warps leave.
    sea::setmaxnreg_dec<wg::PRODUCER_REGS>();
    if (tid >= 32) return;
    if (tid == 0) {
      sea::mbar_arrive_expect_tx(kvbar, 2 * wg::CONSUMERS * Pn::TILE);
      for (int w = 0; w < wg::CONSUMERS; ++w)
        for (int p = 0; p < Pn::NP; ++p) {
          const int row = bh * t_src + col0 + 64 * w;
          sea::tma_load_2d(base + w * Pn::TILE + p * Pn::PANEL, &tk, kvbar, p * Pn::PW, row);
          sea::tma_load_2d(base + L::V_OFF + w * Pn::TILE + p * Pn::PANEL, &tv, kvbar,
                           p * Pn::PW, row);
        }
    }
    for (int w = 0; w < wg::CONSUMERS; ++w) {
      const long off = ((long)bh * nkb + kblock(w)) * nq;
      const int cnt = counts_t[bh * nkb + kblock(w)];
      for (int i = tid; i < cnt; i += 32) lists[w * nq + i] = idx_t[off + i];
    }
    __syncwarp();
    if (tid != 0) return;
    // The walk: the union of the two consumers' sub-tiles in increasing
    // order, each stage tagged with each consumer's list entry.
    auto seek = [&](wg::Walk& x) { return wg::seek_rows(x, block_q, rowbase); };
    wg::Walk w[2];
    bool have[2];
    for (int i = 0; i < 2; ++i) {
      w[i] = wg::Walk{0, -1, counts_t[bh * nkb + kblock(i)], gcol(i), lists + i * nq};
      have[i] = seek(w[i]);
    }
    for (int it = 0;; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) sea::mbar_wait(empty + 8 * st, ((it / STAGES) + 1) & 1);
      int tag[3];
      if (!wg::next(w, have, tag, seek)) {
        meta[4 * st] = -1;
        sea::mbar_arrive(full + 8 * st);
        break;
      }
      for (int i = 0; i < 3; ++i) meta[4 * st + i] = tag[i];
      // the sub-tile's Q and dO, and its rows' lse, delta and mask words
      const long r0 = (long)bh * t_dst + tag[0];
      const uint32_t qs = base + L::STAGE_OFF + st * L::STAGE;
      const uint32_t rows = base + L::ROWS_OFF + st * L::ROWS;
      sea::mbar_arrive_expect_tx(full + 8 * st, L::STAGE + 512 + 256 * n_words);
      for (int p = 0; p < Pn::NP; ++p) {
        sea::tma_load_2d(qs + p * Pn::PANEL, &tq, full + 8 * st, p * Pn::PW, bh * t_dst + tag[0]);
        sea::tma_load_2d(qs + Pn::TILE + p * Pn::PANEL, &tdo, full + 8 * st, p * Pn::PW,
                         bh * t_dst + tag[0]);
      }
      sea::bulk_load(rows, lse + r0, 256, full + 8 * st);
      sea::bulk_load(rows + L::DELTA, delta + r0, 256, full + 8 * st);
      sea::bulk_load(rows + L::MASK, mbits + r0 * n_words, 256 * n_words, full + 8 * st);
    }
    return;
  }

  // A consumer warpgroup: 64 key columns, 16 a warp; a thread holds columns
  // kc = 16·warp + g and kc + 8 (h = 0, 1) and, of each, the q rows or the
  // columns of dk and dv 8·j + 2·t4 + {0, 1} of every accumulator.
  sea::setmaxnreg_inc<wg::CONSUMER_REGS>();
  const int cw = tid / 128 - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kc = 16 * warp + g;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t ks = base + cw * Pn::TILE, vs = base + L::V_OFF + cw * Pn::TILE;

  // dv += Pᵀ·dO and dk += dSᵀ·Q of one sub-tile stay in flight while the
  // next stage is awaited (and, with OVERLAP, while its Sᵀ and dPᵀ run):
  // `pending` is its stage, released once they have completed, and ph, pl,
  // sh, sl are their A fragments (Pᵀ and dSᵀ, hi and lo), kept until then
  constexpr bool OVERLAP = wg::DKV_OVERLAP<D>;
  uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
  int pending = -1;
  // after a wait that completed them: the pending products' stage released
  auto retire = [&] {
    sea::fence_regs(acc_k);
    sea::fence_regs(acc_v);
    sea::fence_frags(ph);
    sea::fence_frags(pl);
    sea::fence_frags(sh);
    sea::fence_frags(sl);
    __syncwarp();
    if (lane == 0 && pending >= 0) sea::mbar_arrive(empty + 8 * pending);
    pending = -1;
  };

  sea::mbar_wait(kvbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    sea::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    const int r0 = meta[4 * st];
    // a sub-tile not in this consumer's walk adds nothing to its columns
    const bool live = r0 >= 0 && meta[4 * st + 1 + cw] >= 0;
    if (!OVERLAP || !live) {
      sea::wgmma_wait<0>();
      retire();
    }
    if (r0 < 0) break;
    if (!live) {
      if (lane == 0) sea::mbar_arrive(empty + 8 * st);
      continue;
    }
    unsigned char* rows = smem + L::ROWS_OFF + st * L::ROWS;
    const float* lses = reinterpret_cast<const float*>(rows);
    const float* dls = reinterpret_cast<const float*>(rows + L::DELTA);
    uint64_t* words = reinterpret_cast<uint64_t*>(rows + L::WORDS) + 64 * cw;
    {
      // the alive words of the sub-tile's 64 rows over this consumer's
      // columns (with OVERLAP while the previous products run): rows q and
      // q + 32 by the quad q, from the rows' mask words in the stage, shared
      // through shared memory
      const int q = (tid & 127) >> 2;
      const int grow0 = wg::global_row(rowbase, r0, block_q);
      const uint32_t* mask = reinterpret_cast<const uint32_t*>(rows + L::MASK);
      sea::AliveRow wrow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = grow0 + q + 32 * h;
        const float wf = (float)(r + 1);
        wrow[h] = sea::AliveRow{mask + (q + 32 * h) * n_words, r, wf, sea::recip(wf),
                                __fdiv_rn((float)t_m, wf), __fdiv_rn(wf, (float)t_m)};
      }
      uint64_t bits[2];
      // (at D = 128 narrow rows a column at a time: sixteen side by side spill)
      sea::alive_bits<false, false, D != 128>(wrow, gcol(cw), t_m, 0, n_words - 1, t4, bits);
      if (t4 == 0) {
        words[q] = bits[0];
        words[q + 32] = bits[1];
      }
      sea::bar_sync(2 + cw, 128);
    }
    const uint32_t qs = base + L::STAGE_OFF + st * L::STAGE, os = qs + Pn::TILE;
    // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ
    float s[32], dp[32];
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sea::wgmma_ss_n64(s, Pn::kdesc(ks, kk), Pn::kdesc(qs, kk), kk > 0);
    sea::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sea::wgmma_ss_n64(dp, Pn::kdesc(vs, kk), Pn::kdesc(os, kk), kk > 0);
    sea::wgmma_commit();

    // Sᵀ (and with OVERLAP the previous products) complete
    sea::wgmma_wait<1>();
    sea::fence_regs(s);
    if (OVERLAP) retire();
    // Pᵀ while dPᵀ runs, by one bit test per element: s[4·j + i] is column
    // kc + 8·(i / 2) and q row 8·j + 2·t4 + i % 2, whose word's bit
    // kc + 8·(i / 2) says it is alive
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rl = 8 * j + 2 * t4;
      const float2 ls = *reinterpret_cast<const float2*>(lses + rl);
      const float2 lr = make_float2(__fmul_rn(ls.x, LOG2E), __fmul_rn(ls.y, LOG2E));
      const ulonglong2 wd = *reinterpret_cast<const ulonglong2*>(words + rl);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint64_t word = i & 1 ? wd.y : wd.x;
        float& y = s[4 * j + i];
        y = (word >> (kc + 8 * (i >> 1))) & 1u ? exp2_sfu(__fmaf_rn(y, LOG2E, -(i & 1 ? lr.y : lr.x)))
                                               : 0.f;
      }
    }
    // dSᵀ = Pᵀ·(dPᵀ − delta) in place of dPᵀ
    sea::wgmma_wait<0>();
    sea::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t4);
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - (i & 1 ? d.y : d.x));
    }
    // the A fragments, a k-step at a time, straight from the accumulators
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      split_bf16(s[2 * i], s[2 * i + 1], ph[i / 4][i % 4], pl[i / 4][i % 4]);
      split_bf16(dp[2 * i], dp[2 * i + 1], sh[i / 4][i % 4], sl[i / 4][i % 4]);
    }

    // dv += Pᵀ·dO and dk += dSᵀ·Q, two wgmmas per 16 rows each (lo first),
    // left in flight
    sea::fence_regs(acc_k);
    sea::fence_regs(acc_v);
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t od = Pn::mndesc(os, kk);
      sea::wgmma_rs<D>(acc_v, pl[kk], od);
      sea::wgmma_rs<D>(acc_v, ph[kk], od);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t qd = Pn::mndesc(qs, kk);
      sea::wgmma_rs<D>(acc_k, sl[kk], qd);
      sea::wgmma_rs<D>(acc_k, sh[kk], qd);
    }
    sea::wgmma_commit();
    pending = st;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long o = ((long)bh * t_src + col0 + 64 * cw + kc + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      wg::store_bf16x2(dk + o + 8 * j, acc_k[4 * j + 2 * h], acc_k[4 * j + 2 * h + 1]);
      wg::store_bf16x2(dv + o + 8 * j, acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The float32 bodies on wgmma in three bf16 terms (K3, K4, K7, K8 in float32)
// ---------------------------------------------------------------------------

namespace f3 {

// Consumer warpgroups (64 rows, dq, or 64 columns, dk/dv, each) and stages
// by head width, as a block's 227 KiB hold them with every operand in three
// bf16 terms (see Layout): at D = 64 two warpgroups and two stages; at 80
// one and two (two and one left the heaviest 128-row blocks of a short T
// as the critical path); at 128 one and one. Two producer warpgroups: warp
// 0 walks and issues the copies, the other seven split. setmaxnreg moves the
// producers' registers to the consumers: 256·48 + 256·208 is the 512-thread
// launch's 128 a thread, 256·48 + 128·248 less than the 384-thread
// launch's 168.
template <int D>
struct Config {
  static constexpr int CONSUMERS = D == 64 ? 2 : 1;
  static constexpr int STAGES = D == 128 ? 1 : 2;
  static constexpr int BLOCK = 64 * CONSUMERS;  // a block's rows (dq) or columns (dk/dv)
  static constexpr int PRODUCERS = 256;
  static constexpr int SPLITTERS = PRODUCERS / 32 - 1;  // their warps that split
  static constexpr int THREADS = PRODUCERS + 128 * CONSUMERS;
  static constexpr int PRODUCER_REGS = 48;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 208 : 248;
};

// Shared memory from a 1024-byte aligned base: each consumer's two resident
// operands (dq: Q, dO; dk/dv: K, V), then the STAGES stages of the streamed
// ones, the early (dq: V; dk/dv: dO) then the late (dq: K; dk/dv: Q), each a
// 64-row tile in three bf16 terms (`sea::Panels`, the terms TILE apart),
// where the operand first lands raw (64 x D float32, `sea::TPanels`, in the
// places of the first two terms: `load_raw`); the mask words (dq: the
// block's rows'; dk/dv: per stage its 64 rows' lse, delta and mask words);
// for dk/dv each consumer's two buffers of 64 alive words; the barriers (per
// stage: early landed, split and released, late the same; the resident
// operands landed and split); each stage's walk tag.
template <int D, bool DKV>
struct Layout {
  using C = Config<D>;
  static constexpr int TILE = sea::Panels<D>::TILE;
  static constexpr int TERMS = 3 * TILE;  // a 64-row operand
  static constexpr int STAGE_OFF = 2 * C::CONSUMERS * TERMS;
  static constexpr int STAGE = 2 * TERMS;  // the early operand, then the late one
  static constexpr int WORDS_OFF = STAGE_OFF + C::STAGES * STAGE;
  // dk/dv: offsets in a stage's rows
  static constexpr int DELTA = 4 * 64, MASK = 8 * 64;
  static constexpr int ROWS = MASK + 64 * MAX_WORDS * 4;
  static constexpr int ALIVE_OFF =
      WORDS_OFF + (DKV ? C::STAGES * ROWS : C::BLOCK * MAX_WORDS * 4);
  static constexpr int BAR_OFF = ALIVE_OFF + (DKV ? C::CONSUMERS * 2 * 512 : 0);
  static constexpr int META_OFF = BAR_OFF + 8 * (6 * C::STAGES + 2);
  static constexpr int BYTES = META_OFF + 16 * C::STAGES + 1024;  // and the base's alignment
  static_assert(BYTES <= 232448, "more shared memory than a block may take");
};

// The barriers' addresses.
struct Bars {
  uint32_t eland, efull, eempty, lland, lfull, lempty, rland, rfull;
};

template <int D, bool DKV>
__device__ __forceinline__ Bars bars(uint32_t base) {
  constexpr int S = 8 * Config<D>::STAGES;
  const uint32_t b = base + Layout<D, DKV>::BAR_OFF;
  return Bars{b, b + S, b + 2 * S, b + 3 * S, b + 4 * S, b + 5 * S, b + 6 * S, b + 6 * S + 8};
}

// The barriers' initialisation, by thread 0.
template <int D, bool DKV>
__device__ __forceinline__ void init_bars(uint32_t base) {
  using C = Config<D>;
  const Bars b = bars<D, DKV>(base);
  for (int s = 0; s < C::STAGES; ++s) {
    sea::mbar_init(b.eland + 8 * s, 1);
    sea::mbar_init(b.efull + 8 * s, C::SPLITTERS);  // one arrival per splitter warp
    sea::mbar_init(b.eempty + 8 * s, 4 * C::CONSUMERS);  // one per consumer warp
    sea::mbar_init(b.lland + 8 * s, 1);
    sea::mbar_init(b.lfull + 8 * s, C::SPLITTERS);
    sea::mbar_init(b.lempty + 8 * s, 4 * C::CONSUMERS);
  }
  sea::mbar_init(b.rland, 1);
  sea::mbar_init(b.rfull, C::SPLITTERS);
  sea::mbar_fence_init();
}

// Rows row .. row + 63 of a float32 tensor map into the operand at `terms`,
// raw, completing on `bar`: raw panel q (`TPanels`' PW columns) lands where
// the first (q even) or second (q odd) term of bf16 panel q / 2 goes, so
// that each bf16 panel's two raw panels sit under its own first two terms
// (`Panels` has twice `TPanels`' columns a panel and the same row and panel
// bytes).
template <int D>
__device__ __forceinline__ void load_raw(uint32_t terms, const CUtensorMap* map, uint32_t bar,
                                         int row) {
  using R = sea::TPanels<64, D>;
  using P = sea::Panels<D>;
  static_assert(P::PW == 2 * R::PW && P::ROW == R::ROW && P::PANEL == R::PANEL,
                "two raw panels a bf16 panel");
  for (int q = 0; q < R::NP; ++q)
    sea::tma_load_2d(terms + (q % 2) * P::TILE + (q / 2) * P::PANEL, map, bar, q * R::PW, row);
}

// The operand at `terms`, landed raw by `load_raw`, written in place as three
// bf16 tiles (`Panels`, TILE apart) by the splitter warps (this one `w`).
// A row of bf16 panel P is one line of each of its two raw panels, and its
// terms go to the same lines (the first and second terms) and to the third
// term's tile, which nothing else uses: so the U lanes that take a row's
// U 16-byte raw pieces read them, meet at __syncwarp, and write their
// pieces' terms (8 bytes a term) over them, and no warp waits for another.
// Two pieces a lane at a time; then made visible to wgmma's reads.
template <int D>
__device__ __forceinline__ void split3_tile(unsigned char* terms, int w, int lane) {
  using R = sea::TPanels<64, D>;
  using P = sea::Panels<D>;
  constexpr int U = 2 * R::ROW / 16;  // a bf16 panel row's raw pieces: 16 or 4 (D = 80)
  constexpr int GROUPS = R::TILE / 16 / 32;  // a warp's 32 pieces at a time
  constexpr int STEP = Config<D>::SPLITTERS;
  constexpr int K = 2;
  static_assert(32 % U == 0, "a row's pieces in one warp");
  for (int g0 = w; g0 < GROUPS; g0 += K * STEP) {
    uint4 x[K];
    uint32_t at[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (g0 + k * STEP) + lane;  // piece j of row r of bf16 panel pn
      const int u = i / U, j = i % U, pn = u / 64, r = u % 64;
      const int h = j / (U / 2), jj = j % (U / 2);  // raw panel 2·pn + h, its piece jj
      at[k] = pn * P::PANEL + sea::swizzled<P::ROW>(r * P::ROW + (h * R::PW + 4 * jj) * 2);
      if (g0 + k * STEP < GROUPS)
        x[k] = *reinterpret_cast<const uint4*>(terms + h * P::TILE + pn * P::PANEL +
                                               sea::swizzled<R::ROW>(r * R::ROW + 16 * jj));
    }
    __syncwarp();  // the rows' raw pieces read before any is overwritten
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g0 + k * STEP >= GROUPS) break;
      uint2 t1, t2, t3;
      sea::split3_bf16(__uint_as_float(x[k].x), __uint_as_float(x[k].y), t1.x, t2.x, t3.x);
      sea::split3_bf16(__uint_as_float(x[k].z), __uint_as_float(x[k].w), t1.y, t2.y, t3.y);
      *reinterpret_cast<uint2*>(terms + at[k]) = t1;
      *reinterpret_cast<uint2*>(terms + P::TILE + at[k]) = t2;
      *reinterpret_cast<uint2*>(terms + 2 * P::TILE + at[k]) = t3;
    }
  }
  sea::fence_proxy_async();
}

// The splitter warps (this one `w`): the resident operands once they have
// landed, then each stage's early and late operand in turn, each split in
// place once it has landed and its barrier signed; the walk's end is a stage
// whose tag is -1.
template <int D, bool DKV>
__device__ __forceinline__ void split_items(unsigned char* smem, uint32_t base, int w, int lane) {
  using C = Config<D>;
  using L = Layout<D, DKV>;
  const Bars b = bars<D, DKV>(base);
  const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF);
  auto signed_off = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) sea::mbar_arrive(bar);
  };
  sea::mbar_wait(b.rland, 0);
  for (int i = 0; i < 2 * C::CONSUMERS; ++i) split3_tile<D>(smem + i * L::TERMS, w, lane);
  signed_off(b.rfull);
  for (int it = 0;; ++it) {
    const int st = it % C::STAGES;
    const uint32_t par = (it / C::STAGES) & 1;
    unsigned char* stage = smem + L::STAGE_OFF + st * L::STAGE;
    sea::mbar_wait(b.eland + 8 * st, par);
    if (meta[4 * st] < 0) {
      signed_off(b.efull + 8 * st);
      return;
    }
    split3_tile<D>(stage, w, lane);
    signed_off(b.efull + 8 * st);
    sea::mbar_wait(b.lland + 8 * st, par);
    split3_tile<D>(stage + L::TERMS, w, lane);
    signed_off(b.lfull + 8 * st);
  }
}

// Warp 0's lane 0: the walk's stage `it` with walk tag `tag` (false: the
// end), once the consumers have released what the stage held: its tag into
// `meta`, its early operand from rows erow .. erow + 63 of `emap` (dk/dv:
// with those rows' lse, delta and n_words mask words from `lse`, `delta`
// and `mask`), then its late one from lrow .. of `lmap`. The end lands
// nothing and carries a tag of -1.
template <int D, bool DKV>
__device__ __forceinline__ void issue_stage(unsigned char* smem, uint32_t base, int it,
                                            bool live, const int (&tag)[3],
                                            const CUtensorMap* emap, int erow,
                                            const CUtensorMap* lmap, int lrow, const float* lse,
                                            const float* delta, const uint32_t* mask,
                                            int n_words) {
  using C = Config<D>;
  using L = Layout<D, DKV>;
  const Bars b = bars<D, DKV>(base);
  int* meta = reinterpret_cast<int*>(smem + L::META_OFF);
  const int st = it % C::STAGES;
  const uint32_t par = ((it / C::STAGES) + 1) & 1;
  const uint32_t stage = base + L::STAGE_OFF + st * L::STAGE;
  if (it >= C::STAGES) sea::mbar_wait(b.eempty + 8 * st, par);
  for (int i = 0; i < 3; ++i) meta[4 * st + i] = live ? tag[i] : -1;
  if (!live) {
    sea::mbar_arrive(b.eland + 8 * st);
    return;
  }
  sea::mbar_arrive_expect_tx(b.eland + 8 * st, 2 * L::TILE + (DKV ? 512 + 256 * n_words : 0));
  load_raw<D>(stage, emap, b.eland + 8 * st, erow);
  if (DKV) {
    const uint32_t rows = base + L::WORDS_OFF + st * L::ROWS;
    sea::bulk_load(rows, lse, 256, b.eland + 8 * st);
    sea::bulk_load(rows + L::DELTA, delta, 256, b.eland + 8 * st);
    sea::bulk_load(rows + L::MASK, mask, 256 * n_words, b.eland + 8 * st);
  }
  if (it >= C::STAGES) sea::mbar_wait(b.lempty + 8 * st, par);
  sea::mbar_arrive_expect_tx(b.lland + 8 * st, 2 * L::TILE);
  load_raw<D>(stage + L::TERMS, lmap, b.lland + 8 * st, lrow);
}

// x as a value the compiler cannot follow: a product's descriptors are
// then built where it is issued, and none is kept in registers across the
// walk (a resident operand's would take 48 registers at D = 128).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// d = a·bᵀ over D to float32's accuracy, m64n64k16: a and b 64-row tiles of
// three bf16 terms each (at a, a + TILE, a + 2·TILE) read K-major; six
// products a k-step, smallest first: a₃b₁, a₂b₂, a₁b₃, a₂b₁, a₁b₂, a₁b₁.
template <int D>
__device__ __forceinline__ void product3_ss(float (&d)[32], uint32_t a, uint32_t b) {
  using P = sea::Panels<D>;
  constexpr uint32_t T = P::TILE;
  a = opaque(a);
  b = opaque(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sea::wgmma_ss_n64(d, P::kdesc(a + 2 * T, kk), P::kdesc(b, kk), kk > 0);
    sea::wgmma_ss_n64(d, P::kdesc(a + T, kk), P::kdesc(b + T, kk), 1);
    sea::wgmma_ss_n64(d, P::kdesc(a, kk), P::kdesc(b + 2 * T, kk), 1);
    sea::wgmma_ss_n64(d, P::kdesc(a + T, kk), P::kdesc(b, kk), 1);
    sea::wgmma_ss_n64(d, P::kdesc(a, kk), P::kdesc(b + T, kk), 1);
    sea::wgmma_ss_n64(d, P::kdesc(a, kk), P::kdesc(b, kk), 1);
  }
}

// d += f·b to float32's accuracy: f a 64-column accumulator in three bf16
// terms as register A fragments (f[t][kk]: term t + 1 of k-step kk), b a
// 64-row tile of three terms read MN-major; the same six products a k-step.
template <int D>
__device__ __forceinline__ void product3_rs(float (&d)[D / 2], const uint32_t (&f)[3][4][4],
                                            uint32_t b) {
  using P = sea::Panels<D>;
  constexpr uint32_t T = P::TILE;
  b = opaque(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b1 = P::mndesc(b, kk), b2 = P::mndesc(b + T, kk), b3 = P::mndesc(b + 2 * T, kk);
    sea::wgmma_rs<D>(d, f[2][kk], b1);
    sea::wgmma_rs<D>(d, f[1][kk], b2);
    sea::wgmma_rs<D>(d, f[0][kk], b3);
    sea::wgmma_rs<D>(d, f[1][kk], b1);
    sea::wgmma_rs<D>(d, f[0][kk], b2);
    sea::wgmma_rs<D>(d, f[0][kk], b1);
  }
}

// A 64-column accumulator's three terms as the A fragments of its four
// k-steps, straight from the accumulator (the bf16 bodies' pairing).
__device__ __forceinline__ void split3_frags(const float (&x)[32], uint32_t (&f)[3][4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    sea::split3_bf16(x[2 * i], x[2 * i + 1], f[0][i / 4][i % 4], f[1][i / 4][i % 4],
                     f[2][i / 4][i % 4]);
}

__device__ __forceinline__ void fence_terms(uint32_t (&f)[3][4][4]) {
  sea::fence_frags(f[0]);
  sea::fence_frags(f[1]);
  sea::fence_frags(f[2]);
}

// A consumer's release of a sub-tile that is not in its walk (it adds
// nothing to its rows or columns): its pending gradient product completes
// and that stage's late operand is released first (at one stage the late
// operand cannot land again before), and this stage's late operand only
// once it is split, so that no warp's release runs a phase ahead.
template <int N>
__device__ __forceinline__ void skip(const Bars& b, int st, uint32_t par, int& pending, int lane,
                                     float (&acc)[N], uint32_t (&f)[3][4][4]) {
  sea::wgmma_wait<0>();
  sea::fence_regs(acc);
  fence_terms(f);
  __syncwarp();
  if (lane == 0) {
    if (pending >= 0) sea::mbar_arrive(b.lempty + 8 * pending);
    sea::mbar_arrive(b.eempty + 8 * st);
  }
  pending = -1;
  sea::mbar_wait(b.lfull + 8 * st, par);
  __syncwarp();
  if (lane == 0) sea::mbar_arrive(b.lempty + 8 * st);
}

}  // namespace f3

// K3 and K7 in float32: dq of 64·CONSUMERS query rows, a consumer warpgroup
// of 64 each; Q and dO resident, V (early) and K (late) streamed.
template <int D>
__global__ void __launch_bounds__(f3::Config<D>::THREADS, 1) causal_dq_f32_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const uint32_t* __restrict__ mbits, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts,
    const int* __restrict__ idx, const int* __restrict__ rowbase, float* __restrict__ dq,
    int t_dst, int t_src, int t_m, int n_words, int block_q, int block_k, int nq, int nkb,
    int col_base) {
  using C = f3::Config<D>;
  using L = f3::Layout<D, false>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sea::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const f3::Bars b = f3::bars<D, false>(base);
  const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF);

  // blocks start with every head's last (heaviest causal) q-tile
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BLOCK;  // first local row
  const int tid = threadIdx.x;
  // k and v hold the (global) columns col_base .. col_stop − 1
  const int col_stop = col_base + t_src;
  // consumer w's q-block and first global row
  auto qblock = [&](int w) { return (row0 + 64 * w) / block_q; };
  auto first_row = [&](int w) { return rowbase[qblock(w)] + (row0 + 64 * w - qblock(w) * block_q); };

  if (tid == 0) f3::init_bars<D, false>(base);
  __syncthreads();

  if (tid < C::PRODUCERS) {
    sea::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid >= 32) {
      f3::split_items<D, false>(smem, base, (tid >> 5) - 1, tid & 31);
      return;
    }
    if (tid != 0) return;
    // Q and dO of each consumer and the block's mask words, then the walk:
    // the union of the consumers' sub-tiles in increasing order, each
    // stage's V, then its K
    sea::mbar_arrive_expect_tx(b.rland, 2 * C::CONSUMERS * 2 * L::TILE + C::BLOCK * n_words * 4);
    for (int w = 0; w < C::CONSUMERS; ++w) {
      const int row = bh * t_dst + row0 + 64 * w;
      f3::load_raw<D>(base + 2 * w * L::TERMS, &tq, b.rland, row);
      f3::load_raw<D>(base + (2 * w + 1) * L::TERMS, &tdo, b.rland, row);
    }
    sea::bulk_load(base + L::WORDS_OFF, mbits + ((long)bh * t_dst + row0) * n_words,
                   C::BLOCK * n_words * 4, b.rland);
    auto seek = [&](wg::Walk& x) { return wg::seek_cols(x, block_k, col_stop); };
    wg::Walk w[2];
    bool have[2] = {false, false};
    for (int i = 0; i < C::CONSUMERS; ++i) {
      w[i] = wg::Walk{0, -1, counts[bh * nq + qblock(i)], first_row(i) + 64,
                      idx + ((long)bh * nq + qblock(i)) * nkb};
      have[i] = seek(w[i]);
    }
    for (int it = 0;; ++it) {
      int tag[3] = {0, 0, 0};
      const bool live = wg::next(w, have, tag, seek);
      const int krow = bh * t_src + tag[0] - col_base;
      f3::issue_stage<D, false>(smem, base, it, live, tag, &tv, krow, &tk, krow, nullptr,
                                nullptr, nullptr, 0);
      if (!live) break;
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, 16 a warp; a thread holds rows g
  // and g + 8 of its warp's (h = 0, 1) and, of each, the columns 8·j +
  // 2·t4 + {0, 1} of every accumulator.
  sea::setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = (tid - C::PRODUCERS) / 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lrow0 = row0 + 64 * cw;  // the consumer's first local row
  const int grow0 = first_row(cw);
  const uint32_t* Ms = reinterpret_cast<const uint32_t*>(smem + L::WORDS_OFF);

  // per row h: lse·log2 e, delta, and what its alive words need
  float l2[2], dl[2];
  sea::AliveRow rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 16 * warp + g + 8 * h;
    const int r = grow0 + rl;
    const long gr = (long)bh * t_dst + lrow0 + rl;
    l2[h] = __fmul_rn(lse[gr], LOG2E);
    dl[h] = delta[gr];
    const float wf = (float)(r + 1);
    rows[h] = sea::AliveRow{Ms + (64 * cw + rl) * n_words, r, wf, sea::recip(wf),
                            __fdiv_rn((float)t_m, wf), __fdiv_rn(wf, (float)t_m)};
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t qs = base + 2 * cw * L::TERMS, os = qs + L::TERMS;

  // dq += dS·K of one sub-tile runs while the next stage is awaited:
  // `pending` is its stage, whose K is released once it has completed, and
  // f are its A fragments (dS in three terms), kept until then
  uint32_t f[3][4][4];
  int pending = -1;

  // the operands split and (TMA's writes seen through their own barrier)
  // the mask words landed
  sea::mbar_wait(b.rfull, 0);
  sea::mbar_wait(b.rland, 0);
  for (int it = 0;; ++it) {
    const int st = it % C::STAGES;
    const uint32_t par = (it / C::STAGES) & 1;
    sea::mbar_wait(b.efull + 8 * st, par);
    const int c0 = meta[4 * st];
    if (c0 < 0) break;
    if (meta[4 * st + 1 + cw] < 0) {
      f3::skip(b, st, par, pending, lane, acc, f);
      continue;
    }
    const uint32_t vs = base + L::STAGE_OFF + st * L::STAGE, ks = vs + L::TERMS;
    // the previous dq product has completed: its K is released
    sea::wgmma_wait<0>();
    sea::fence_regs(acc);
    f3::fence_terms(f);
    __syncwarp();
    if (lane == 0 && pending >= 0) sea::mbar_arrive(b.lempty + 8 * pending);
    // dP = dO·Vᵀ; the rows' alive words while it runs; then S = Q·Kᵀ once K
    // is split (issuing S before the words, where two stages allow, was
    // slower)
    float s[32], dp[32];
    sea::wgmma_fence();
    f3::product3_ss<D>(dp, os, vs);
    sea::wgmma_commit();
    uint64_t bits[2];
    sea::alive_bits<false, false>(rows, c0, t_m, 0, n_words - 1, t4, bits);
    sea::mbar_wait(b.lfull + 8 * st, par);
    sea::wgmma_fence();  // s's registers may have held the words' temporaries
    f3::product3_ss<D>(s, qs, ks);
    sea::wgmma_commit();
    // dP has completed: V is released
    sea::wgmma_wait<1>();
    sea::fence_regs(dp);
    __syncwarp();
    if (lane == 0) sea::mbar_arrive(b.eempty + 8 * st);
    sea::wgmma_wait<0>();
    sea::fence_regs(s);

    // P by one bit test per element: element j of row h is s[4·(j / 2) +
    // 2·h + j % 2], column c0 + 8·(j / 2) + 2·t4 + j % 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t a = bits[h] >> (2 * t4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float& x = s[4 * (j >> 1) + 2 * h + (j & 1)];
        x = (a >> (8 * (j >> 1) + (j & 1))) & 1u ? exp2_sfu(__fmaf_rn(x, LOG2E, -l2[h])) : 0.f;
      }
    }
    // dS = P·(dP − delta) in place of P, in three terms
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
    f3::split3_frags(s, f);

    // dq += dS·K, six wgmmas a k-step, left in flight
    sea::fence_regs(acc);
    sea::wgmma_fence();
    f3::product3_rs<D>(acc, f, ks);
    sea::wgmma_commit();
    pending = st;
  }
  sea::wgmma_wait<0>();
  sea::fence_regs(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = dq + ((long)bh * t_dst + lrow0 + 16 * warp + g + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// K4 and K8 in float32: dk and dv of 64·CONSUMERS key columns, a consumer
// warpgroup of 64 each; K and V resident, dO (early, with its rows' lse,
// delta and mask words) and Q (late) streamed.
template <int D>
__global__ void __launch_bounds__(f3::Config<D>::THREADS, 1) causal_dkv_f32_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const uint32_t* __restrict__ mbits, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts_t,
    const int* __restrict__ idx_t, const int* __restrict__ rowbase, float* __restrict__ dk,
    float* __restrict__ dv, int t_dst, int t_src, int t_m, int n_words, int block_q,
    int block_k, int nq, int nkb, int col_base) {
  using C = f3::Config<D>;
  using L = f3::Layout<D, true>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sea::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const f3::Bars b = f3::bars<D, true>(base);
  const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF);

  // blocks start with every head's first (heaviest causal) k-tile
  const int bh = blockIdx.x;
  const int col0 = blockIdx.y * C::BLOCK;  // first local column of the block
  const int tid = threadIdx.x;
  // consumer w's k-block of the transposed lists, and its first global column
  auto kblock = [&](int w) { return (col0 + 64 * w) / block_k; };
  auto gcol = [&](int w) { return col_base + col0 + 64 * w; };

  if (tid == 0) f3::init_bars<D, true>(base);
  __syncthreads();

  if (tid < C::PRODUCERS) {
    sea::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid >= 32) {
      f3::split_items<D, true>(smem, base, (tid >> 5) - 1, tid & 31);
      return;
    }
    if (tid != 0) return;
    // K and V of each consumer, then the walk: the union of the consumers'
    // sub-tiles in increasing order, each stage's dO with its rows' lse,
    // delta and mask words, then its Q
    sea::mbar_arrive_expect_tx(b.rland, 2 * C::CONSUMERS * 2 * L::TILE);
    for (int w = 0; w < C::CONSUMERS; ++w) {
      const int row = bh * t_src + col0 + 64 * w;
      f3::load_raw<D>(base + 2 * w * L::TERMS, &tk, b.rland, row);
      f3::load_raw<D>(base + (2 * w + 1) * L::TERMS, &tv, b.rland, row);
    }
    auto seek = [&](wg::Walk& x) { return wg::seek_rows(x, block_q, rowbase); };
    wg::Walk w[2];
    bool have[2] = {false, false};
    for (int i = 0; i < C::CONSUMERS; ++i) {
      w[i] = wg::Walk{0, -1, counts_t[bh * nkb + kblock(i)], gcol(i),
                      idx_t + ((long)bh * nkb + kblock(i)) * nq};
      have[i] = seek(w[i]);
    }
    for (int it = 0;; ++it) {
      int tag[3] = {0, 0, 0};
      const bool live = wg::next(w, have, tag, seek);
      const int r0 = bh * t_dst + tag[0];
      f3::issue_stage<D, true>(smem, base, it, live, tag, &tdo, r0, &tq, r0, lse + r0,
                               delta + r0, mbits + (long)r0 * n_words, n_words);
      if (!live) break;
    }
    return;
  }

  // A consumer warpgroup: 64 key columns, 16 a warp; a thread holds columns
  // kc = 16·warp + g and kc + 8 (h = 0, 1) and, of each, the q rows or the
  // columns of dk and dv 8·j + 2·t4 + {0, 1} of every accumulator.
  sea::setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = (tid - C::PRODUCERS) / 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kc = 16 * warp + g;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t ks = base + 2 * cw * L::TERMS, vs = ks + L::TERMS;
  // the consumer's two buffers of 64 alive words, taken in turn
  uint64_t* const wbuf = reinterpret_cast<uint64_t*>(smem + L::ALIVE_OFF) + 128 * cw;

  // dk += dSᵀ·Q of one sub-tile runs while the next stage is awaited:
  // `pending` is its stage, whose Q is released once it has completed, and
  // f are its A fragments (dSᵀ in three terms; Pᵀ's before)
  uint32_t f[3][4][4];
  int pending = -1, built = 0;

  sea::mbar_wait(b.rfull, 0);
  for (int it = 0;; ++it) {
    const int st = it % C::STAGES;
    const uint32_t par = (it / C::STAGES) & 1;
    sea::mbar_wait(b.efull + 8 * st, par);
    const int r0 = meta[4 * st];
    if (r0 < 0) break;
    if (meta[4 * st + 1 + cw] < 0) {
      f3::skip(b, st, par, pending, lane, acc_k, f);
      continue;
    }
    const uint32_t os = base + L::STAGE_OFF + st * L::STAGE, qs = os + L::TERMS;
    // the stage's rows, landed by TMA with dO (seen through their own barrier)
    sea::mbar_wait(b.eland + 8 * st, par);
    const unsigned char* rows = smem + L::WORDS_OFF + st * L::ROWS;
    const float* lses = reinterpret_cast<const float*>(rows);
    const float* dls = reinterpret_cast<const float*>(rows + L::DELTA);
    uint64_t* words = wbuf + 64 * (built++ & 1);
    // the previous dk product has completed: its Q is released
    sea::wgmma_wait<0>();
    sea::fence_regs(acc_k);
    f3::fence_terms(f);
    __syncwarp();
    if (lane == 0 && pending >= 0) sea::mbar_arrive(b.lempty + 8 * pending);
    // dPᵀ = V·dOᵀ; the alive words while it runs; then Sᵀ = K·Qᵀ once Q is
    // split
    float s[32], dp[32];
    sea::wgmma_fence();
    f3::product3_ss<D>(dp, vs, os);
    sea::wgmma_commit();
    {
      // the alive words of the sub-tile's 64 rows over this consumer's
      // columns: rows q and q + 32 by the quad q, from the rows' mask words
      // in the stage, shared through shared memory
      const int q = (tid & 127) >> 2;
      const int grow0 = wg::global_row(rowbase, r0, block_q);
      const uint32_t* mask = reinterpret_cast<const uint32_t*>(rows + L::MASK);
      sea::AliveRow wrow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = grow0 + q + 32 * h;
        const float wf = (float)(r + 1);
        wrow[h] = sea::AliveRow{mask + (q + 32 * h) * n_words, r, wf, sea::recip(wf),
                                __fdiv_rn((float)t_m, wf), __fdiv_rn(wf, (float)t_m)};
      }
      uint64_t bits[2];
      // (at D = 128 narrow rows a column at a time: sixteen side by side spill)
      sea::alive_bits<false, false, D != 128>(wrow, gcol(cw), t_m, 0, n_words - 1, t4, bits);
      if (t4 == 0) {
        words[q] = bits[0];
        words[q + 32] = bits[1];
      }
      sea::bar_sync(1 + cw, 128);
    }
    sea::mbar_wait(b.lfull + 8 * st, par);
    sea::wgmma_fence();  // s's registers may have held the words' temporaries
    f3::product3_ss<D>(s, ks, qs);
    sea::wgmma_commit();
    sea::wgmma_wait<0>();
    sea::fence_regs(s);
    sea::fence_regs(dp);

    // Pᵀ by one bit test per element: s[4·j + i] is column kc + 8·(i / 2)
    // and q row 8·j + 2·t4 + i % 2, whose word's bit kc + 8·(i / 2) says it
    // is alive; then dSᵀ = Pᵀ·(dPᵀ − delta) in place of dPᵀ
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rl = 8 * j + 2 * t4;
      const float2 ls = *reinterpret_cast<const float2*>(lses + rl);
      const float2 lr = make_float2(__fmul_rn(ls.x, LOG2E), __fmul_rn(ls.y, LOG2E));
      const float2 d = *reinterpret_cast<const float2*>(dls + rl);
      const ulonglong2 wd = *reinterpret_cast<const ulonglong2*>(words + rl);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint64_t word = i & 1 ? wd.y : wd.x;
        float& y = s[4 * j + i];
        y = (word >> (kc + 8 * (i >> 1))) & 1u ? exp2_sfu(__fmaf_rn(y, LOG2E, -(i & 1 ? lr.y : lr.x)))
                                               : 0.f;
        dp[4 * j + i] = y * (dp[4 * j + i] - (i & 1 ? d.y : d.x));
      }
    }

    // dv += Pᵀ·dO, six wgmmas a k-step; once it has completed dO (and the
    // stage's rows) are released
    f3::split3_frags(s, f);
    sea::fence_regs(acc_v);
    sea::wgmma_fence();
    f3::product3_rs<D>(acc_v, f, os);
    sea::wgmma_commit();
    sea::wgmma_wait<0>();
    sea::fence_regs(acc_v);
    f3::fence_terms(f);
    __syncwarp();
    if (lane == 0) sea::mbar_arrive(b.eempty + 8 * st);
    // dk += dSᵀ·Q, left in flight
    f3::split3_frags(dp, f);
    sea::fence_regs(acc_k);
    sea::wgmma_fence();
    f3::product3_rs<D>(acc_k, f, qs);
    sea::wgmma_commit();
    pending = st;
  }
  sea::wgmma_wait<0>();
  sea::fence_regs(acc_k);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long o = ((long)bh * t_src + col0 + 64 * cw + kc + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + o + 8 * j) =
          make_float2(acc_k[4 * j + 2 * h], acc_k[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dv + o + 8 * j) =
          make_float2(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// col_base: the global column of k's and v's first row (0 for K3 and K4).
// D: the head width; T: the element type of q, k, v, dou and the gradients
// (float: the body in three bf16 terms, __nv_bfloat16: the bf16 body; each
// on tiles of 128 rows, or 64 for float32 at D = 128, so t_dst a multiple of
// 128); lse and delta are float32 either way.
template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* mbits, const void* dou, const void* lse,
                      const void* delta, const void* counts, const void* idx,
                      const void* rowbase, void* dq, int nh, int t_dst,
                      int t_src, int t_m, int n_words, int block_q,
                      int block_k, int nq, int nkb, int col_base,
                      cudaStream_t stream) {
  if (misaligned(q, k, v, dou, dq)) return cudaErrorInvalidValue;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  CUtensorMap tq, tk, tv, tdo;
  if constexpr (std::is_same<T, float>::value) {
    using C = f3::Config<D>;
    using L = f3::Layout<D, false>;
    constexpr int PW = sea::TPanels<64, D>::PW;
    if (t_dst % C::BLOCK != 0 || misaligned(mbits)) return cudaErrorInvalidValue;
    cudaError_t e = sea::f32_map<PW>(&tq, q, (long)nh * t_dst, D);
    if (e == cudaSuccess) e = sea::f32_map<PW>(&tk, k, (long)nh * t_src, D);
    if (e == cudaSuccess) e = sea::f32_map<PW>(&tv, v, (long)nh * t_src, D);
    if (e == cudaSuccess) e = sea::f32_map<PW>(&tdo, dou, (long)nh * t_dst, D);
    if (e == cudaSuccess) e = sea::opt_in_smem(causal_dq_f32_wgmma_kernel<D>, L::BYTES, opted_in);
    if (e != cudaSuccess) return e;
    dim3 grid(nh, t_dst / C::BLOCK);
    causal_dq_f32_wgmma_kernel<D><<<grid, C::THREADS, L::BYTES, stream>>>(
        tq, tk, tv, tdo, (const uint32_t*)mbits, (const float*)lse, (const float*)delta,
        (const int*)counts, (const int*)idx, (const int*)rowbase, (float*)dq, t_dst, t_src, t_m,
        n_words, block_q, block_k, nq, nkb, col_base);
  } else {
    const int bytes = wg::DqLayout<D>::FIXED + wg::CONSUMERS * nkb * 4;
    if (t_dst % wg::BLOCK != 0 || bytes > wg::SMEM_MAX || misaligned(mbits))
      return cudaErrorInvalidValue;
    cudaError_t e = sea::tile_map<D>(&tq, q, (long)nh * t_dst);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tk, k, (long)nh * t_src);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tv, v, (long)nh * t_src);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tdo, dou, (long)nh * t_dst);
    if (e == cudaSuccess) e = sea::opt_in_smem(causal_dq_wgmma_kernel<D>, wg::SMEM_MAX, opted_in);
    if (e != cudaSuccess) return e;
    dim3 grid(nh, t_dst / wg::BLOCK);
    causal_dq_wgmma_kernel<D><<<grid, wg::THREADS, bytes, stream>>>(
        tq, tk, tv, tdo, (const uint32_t*)mbits, (const float*)lse, (const float*)delta,
        (const int*)counts, (const int*)idx, (const int*)rowbase, (__nv_bfloat16*)dq, t_dst,
        t_src, t_m, n_words, block_q, block_k, nq, nkb, col_base);
  }
  return cudaGetLastError();
}

// The same for dk/dv (t_src a multiple of 128).
template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* mbits, const void* dou, const void* lse,
                       const void* delta, const void* counts_t,
                       const void* idx_t, const void* rowbase, void* dk,
                       void* dv, int nh, int t_dst, int t_src, int t_m,
                       int n_words, int block_q, int block_k, int nq, int nkb,
                       int col_base, cudaStream_t stream) {
  if (misaligned(q, k, v, dou, dk, dv)) return cudaErrorInvalidValue;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  CUtensorMap tq, tk, tv, tdo;
  if constexpr (std::is_same<T, float>::value) {
    using C = f3::Config<D>;
    using L = f3::Layout<D, true>;
    constexpr int PW = sea::TPanels<64, D>::PW;
    if (t_src % C::BLOCK != 0 || misaligned(mbits, lse, delta)) return cudaErrorInvalidValue;
    cudaError_t e = sea::f32_map<PW>(&tq, q, (long)nh * t_dst, D);
    if (e == cudaSuccess) e = sea::f32_map<PW>(&tk, k, (long)nh * t_src, D);
    if (e == cudaSuccess) e = sea::f32_map<PW>(&tv, v, (long)nh * t_src, D);
    if (e == cudaSuccess) e = sea::f32_map<PW>(&tdo, dou, (long)nh * t_dst, D);
    if (e == cudaSuccess) e = sea::opt_in_smem(causal_dkv_f32_wgmma_kernel<D>, L::BYTES, opted_in);
    if (e != cudaSuccess) return e;
    dim3 grid(nh, t_src / C::BLOCK);
    causal_dkv_f32_wgmma_kernel<D><<<grid, C::THREADS, L::BYTES, stream>>>(
        tq, tk, tv, tdo, (const uint32_t*)mbits, (const float*)lse, (const float*)delta,
        (const int*)counts_t, (const int*)idx_t, (const int*)rowbase, (float*)dk, (float*)dv,
        t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, col_base);
  } else {
    const int bytes = wg::DkvLayout<D>::FIXED + wg::CONSUMERS * nq * 4;
    if (t_src % wg::BLOCK != 0 || bytes > wg::SMEM_MAX || misaligned(mbits, lse, delta))
      return cudaErrorInvalidValue;
    cudaError_t e = sea::tile_map<D>(&tq, q, (long)nh * t_dst);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tk, k, (long)nh * t_src);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tv, v, (long)nh * t_src);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tdo, dou, (long)nh * t_dst);
    if (e == cudaSuccess) e = sea::opt_in_smem(causal_dkv_wgmma_kernel<D>, wg::SMEM_MAX, opted_in);
    if (e != cudaSuccess) return e;
    dim3 grid(nh, t_src / wg::BLOCK);
    causal_dkv_wgmma_kernel<D><<<grid, wg::THREADS, bytes, stream>>>(
        tq, tk, tv, tdo, (const uint32_t*)mbits, (const float*)lse, (const float*)delta,
        (const int*)counts_t, (const int*)idx_t, (const int*)rowbase, (__nv_bfloat16*)dk,
        (__nv_bfloat16*)dv, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, col_base);
  }
  return cudaGetLastError();
}

}  // namespace

// K3: dq (nh, t_dst, D) in q's type, float32 or bf16 (is_bf16); head width
// 64, 80 or 128.
extern "C" int sea_causal_dq(const void* q, const void* k, const void* v,
                             const void* mbits, const void* dou,
                             const void* lse, const void* delta,
                             const void* counts, const void* idx,
                             const void* rowbase, void* dq, int nh, int t_dst,
                             int t_src, int head_dim, int t_m, int n_words,
                             int block_q, int block_k, int nq, int nkb,
                             int is_bf16, void* stream) {
  if (bad_geometry(sea::TRAIN_WIDTHS{}, head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(sea::TRAIN_WIDTHS{}, head_dim, is_bf16, [&](auto d, auto t) {
    return launch_dq<decltype(d)::value, typename decltype(t)::type>(
        q, k, v, mbits, dou, lse, delta, counts, idx, rowbase, dq, nh, t_dst, t_src, t_m,
        n_words, block_q, block_k, nq, nkb, 0, (cudaStream_t)stream);
  });
}

// K4: dk, dv (nh, t_src, D) in q's type, float32 or bf16 (is_bf16); head
// width 64, 80 or 128.
extern "C" int sea_causal_dkv(const void* q, const void* k, const void* v,
                              const void* mbits, const void* dou,
                              const void* lse, const void* delta,
                              const void* counts_t, const void* idx_t,
                              const void* rowbase, void* dk, void* dv, int nh,
                              int t_dst, int t_src, int head_dim, int t_m,
                              int n_words, int block_q, int block_k, int nq,
                              int nkb, int is_bf16, void* stream) {
  if (bad_geometry(sea::TRAIN_WIDTHS{}, head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(sea::TRAIN_WIDTHS{}, head_dim, is_bf16, [&](auto d, auto t) {
    return launch_dkv<decltype(d)::value, typename decltype(t)::type>(
        q, k, v, mbits, dou, lse, delta, counts_t, idx_t, rowbase, dk, dv, nh, t_dst, t_src,
        t_m, n_words, block_q, block_k, nq, nkb, 0, (cudaStream_t)stream);
  });
}

// K7: dq (nh, t_dst, D) of one K/V window, in q's type (float32 or bf16,
// head width 64: K3's instance). k and v are (nh, t_win, D) and hold the
// global columns col_base .. col_base + t_win − 1; idx (nh, nq, nkw) carries
// global k-block ids of that window; lse and delta (float32) are the rows'
// totals over every window (lse +inf on rows with nothing alive at all).
extern "C" int sea_window_dq(const void* q, const void* k, const void* v,
                             const void* mbits, const void* dou,
                             const void* lse, const void* delta,
                             const void* counts, const void* idx,
                             const void* rowbase, void* dq, int nh, int t_dst,
                             int t_win, int head_dim, int t_m, int n_words,
                             int block_q, int block_k, int nq, int nkw,
                             int col_base, int is_bf16, void* stream) {
  if (bad_geometry(sea::BASE_WIDTHS{}, head_dim, n_words, t_dst, t_win, block_q, block_k) ||
      bad_window(col_base, block_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_dq<64, __nv_bfloat16>(q, k, v, mbits, dou, lse, delta, counts,
                                                      idx, rowbase, dq, nh, t_dst, t_win, t_m,
                                                      n_words, block_q, block_k, nq, nkw,
                                                      col_base, s)
                       : launch_dq<64, float>(q, k, v, mbits, dou, lse, delta, counts, idx,
                                              rowbase, dq, nh, t_dst, t_win, t_m, n_words,
                                              block_q, block_k, nq, nkw, col_base, s));
}

// K8: dk, dv (nh, t_win, D) of one K/V window from the local query rows, in
// q's type (float32 or bf16, head width 64: K4's instance). counts_t (nh,
// nkw) and idx_t (nh, nkw, nq) are the window's transposed lists: per local
// k-block, the local q-blocks with an alive element in it.
extern "C" int sea_window_dkv(const void* q, const void* k, const void* v,
                              const void* mbits, const void* dou,
                              const void* lse, const void* delta,
                              const void* counts_t, const void* idx_t,
                              const void* rowbase, void* dk, void* dv, int nh,
                              int t_dst, int t_win, int head_dim, int t_m,
                              int n_words, int block_q, int block_k, int nq,
                              int nkw, int col_base, int is_bf16, void* stream) {
  if (bad_geometry(sea::BASE_WIDTHS{}, head_dim, n_words, t_dst, t_win, block_q, block_k) ||
      bad_window(col_base, block_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_dkv<64, __nv_bfloat16>(q, k, v, mbits, dou, lse, delta,
                                                       counts_t, idx_t, rowbase, dk, dv, nh,
                                                       t_dst, t_win, t_m, n_words, block_q,
                                                       block_k, nq, nkw, col_base, s)
                       : launch_dkv<64, float>(q, k, v, mbits, dou, lse, delta, counts_t,
                                               idx_t, rowbase, dk, dv, nh, t_dst, t_win, t_m,
                                               n_words, block_q, block_k, nq, nkw, col_base,
                                               s));
}
