// Fused block-sparse SEA attention forward kernels for Hopper (sm_90a): the
// causal forward, its forward-with-stats variant, the padded bidirectional
// forward and the causal forward's three impl variants, instances of one
// forward body, written twice on wgmma and TMA: `causal_wgmma_kernel` for
// bf16 and `causal_tf32_wgmma_kernel` for float32 (split TF32), but for K5
// in float32, which keeps `causal_flat_kernel` on mma.sync.
//
// Replaces these TPU kernels of sea_tpu/ops/kernels/block_sparse.py:
//   * `_causal_kernel_flat` (impl "flat", the causal benchmark path), entry
//     point `sea_causal_flat_forward` (K1);
//   * `_causal_kernel_fwd_stats` (the forward of the differentiable
//     `fused_sparse_attention`), entry point `sea_causal_fwd_stats` (K2,
//     float32 or bf16): the body instantiated with STATS = true, without
//     the undersampling predicate, and writing the per-row logsumexp (+inf
//     on rows with no alive column) that the backward kernels
//     (block_sparse_diff.cu) read;
//   * `_kernel` (the padded bidirectional path of BERT/LRA benchmarking),
//     entry point `sea_bidir_forward` (K5): the body instantiated with
//     BIDIR = true;
//   * `_causal_kernel_fwd_stats_cb` (`fwd_stats_window`, the ring forward of
//     sea_tpu/parallel/sharded_attention.py), entry point
//     `sea_window_fwd_stats` (K6): K2's instance over one K/V window. The
//     window holds the global columns col_base .. col_base + t_src − 1; the
//     tile lists carry global k-block ids, the pixel and causal math use
//     global columns, and only the K/V loads (bf16: the tensor maps' rows)
//     subtract col_base. The scaler is one (the ring applies the real one
//     after merging the windows), and a row with nothing alive in the window
//     gets lse = +inf and a zero output, as in K2. K1, K2 and K5 pass
//     col_base = 0 and their whole K/V;
//   * the variants that `sea_block_sparse_attention(..., impl=)` selects,
//     each K1's function with a restricted predicate (IMPL): entry points
//     `sea_causal_word_range_forward` (K9a, `_causal_kernel_flat_wr`, impl
//     "flat_wr"), `sea_causal_word_loop_forward` (K9b,
//     `_causal_kernel_flat_fori`, impl "flat_fori") and
//     `sea_causal_subtile_forward` (K9c, `_causal_kernel`, impl "subtile");
//     see "The impl variants" below.
// For every (batch·head, query row r) it computes
//
//     out[r] = scaler[r] · softmax over alive s of (q_r · k_s) · v_s
//
// Causal: column s is alive iff s <= r and the packed compressed mask of row
// r has bit pixel(r, s) = floor((s + 0.5) / (r + 1) · T_M − 1e-4).
// Bidirectional: every row of (batch·head) b has the width len = lengths[b],
// the example's token count; s is alive iff s < len and the row's mask has
// bit clip(floor((s + 0.5) / len · T_M − 1e-4), 0, T_M − 1). The caller
// divides q by sqrt(D) first. Rows with no alive column give 0. Optionally
// (causal only) the train path's undersampling keep-predicate
// (oversample != 1) applies too, and `rowbase` shifts each q-block's rows to
// global positions.
//
// What bounds it on this card. The function itself is bound by bytes: it
// needs 4·D FLOPs per alive element only, and the main path's masks keep
// about 2-12% of the causal triangle, so reading q, k, v, the mask bits and
// the scaler once and writing out at HBM's 3.35 TB/s takes longer than the
// alive work. The kernel does not gather alive columns: it does the dense
// work of every visited 64-column sub-tile (for bf16, 4·64·64·D FLOPs a 64
// rows: Q·Kᵀ and P·V's two halves; for float32 each product three times in
// TF32), and the 64 x 64 lists keep nearly the
// whole triangle on these masks. So its time goes to the products, to the
// predicate and the softmax per element on the ALU and SFU pipes, and to
// reading each visited K/V sub-tile from L2 once per q-tile.
//
// The bf16 body (`causal_wgmma_kernel`). One block of three warpgroups per
// (batch·head, 128-row q-tile), every head's last (heaviest causal) q-tile
// first:
//   * products on wgmma (m64nNk16, bf16 operands, float32 accumulators):
//     S = Q·Kᵀ with Q and K read from shared memory through descriptors, and
//     P·V with P from registers as the A operand, the S accumulators as they
//     stand, and V from shared memory read MN-major (transposed). P is split
//     as P_hi = bf16(P) and P_lo = bf16(P − P_hi), two wgmmas into the same
//     accumulator (relative error about 2^-16, where one rounding of P would
//     cost 2^-9 and break the half-ulp gate on rows that cancel). This
//     answers the products: mma.sync reached part of the tensor cores' rate;
//   * copies by TMA: the producer warpgroup (setmaxnreg down to 40
//     registers) stages both q-blocks' lists in shared memory, and one lane
//     walks their union in increasing order and fills a ring of four K/V
//     stages, each completing on an mbarrier, in the swizzled layout the
//     descriptors read (a 128-byte swizzle at D = 64 and 128; at D = 80,
//     whose 160-byte rows no 64-column box tiles, a 32-byte swizzle, five
//     16-column boxes a tile, and at D = 32 two); Q and the block's mask words arrive once on
//     their own barrier. The C entry points build the tensor maps (over the
//     window at K6) with cuTensorMapEncodeTiled, found through
//     cudaGetDriverEntryPointByVersion so that no -lcuda is needed. This
//     answers the copies: no consumer thread spends an instruction or a
//     register on them, and the next sub-tiles load while this one runs;
//   * two consumer warpgroups (setmaxnreg up to 232 registers) of 64 rows
//     each share every stage, so each K/V sub-tile is read from L2 once per
//     128 rows, not per 64. A sub-tile absent from a warpgroup's own list
//     (its q-block's, at block_q 64) is dead for it and skipped; the stage
//     is released once both warpgroups' warps have arrived. A warpgroup's
//     P·V stays in flight while its next sub-tile's Q·Kᵀ and alive words
//     run. This answers the lockstep warps and the L2 reads;
//   * the predicate is one bit test per element: once per (row, sub-tile)
//     the row's 64-bit alive word is built from the row's pixel boundaries
//     (`sea::alive_bits`, sea_mask.cuh: only where aliveness changes, each
//     boundary by algebra and one evaluation of the pinned pixel), by the
//     quad of lanes that shares the row, with the causal edge, K5's length,
//     K9a-b's word range and K1's undersampling keep-predicate folded in.
//     This answers the predicate's ~20 instructions per element;
//   * exp(x − m) is 2^(x·log2 e − m·log2 e) on the SFU (ex2.approx, about
//     2^-22 relative), whose 2^0 is 1 exactly; row max and sum by a fixed
//     pairwise tree, then the quad's shuffles;
//   * deterministic: no atomics, no row split across blocks, each row's sums
//     in a fixed order. A sub-tile with no alive element in a row leaves
//     that row's m, l and acc exactly as they were (corr = 2^0 = 1, P = 0),
//     so a variant that skips it or a shard that never lists it gives the
//     same bits.
// Registers: ptxas reports 168 for the launch (384 threads); the consumers
// run under 232 and the producer under 40 after setmaxnreg, no spill.
// Shared memory a block (bytes): Q 256·D, four K/V stages 4·256·D, the
// mask words 8192, barriers and walk entries 136, the alignment 1024, and
// 8·nkb (K9a-c 16·nkb) for the lists: 50312, 91272, 111752 and 173192 plus
// the lists at D = 32, 64, 80 and 128. The tiles need t_dst a multiple of
// 128.
//
// The float32 body (`causal_tf32_wgmma_kernel`) is the bf16 body's skeleton
// (the walk, the TMA copies on mbarriers, warp specialisation under
// setmaxnreg, the alive words, the softmax, the epilogue) with its products
// in split TF32 ("3xTF32"): each operand is hi + lo in TF32 (rounded as
// cvt.rna rounds, by integer operations: `split_tf32_rna`), and a·b is
// summed as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi per 8-wide k-step on
// wgmma m64nNk8 TF32 into float32, for both products, keeping float32
// accuracy to a few 1e-7. What is new is where the operands come from:
//   * wgmma reads TF32 operands K-major only. S = Q·Kᵀ is K-major as Q and K
//     stand; P·V reads V as Vᵀ (the keys along each row). Every operand
//     lands raw by TMA and is split on the chip, hi and lo: Q once per
//     block, in place, by its warpgroup; each K sub-tile in place in its
//     stage, and each V sub-tile from a slot of its own, transposed into its
//     stage's Vᵀ, by seven warps of two producer warpgroups (the eighth
//     issues the copies), on barriers of their own between the copy and the
//     consumers. (A pre-pass that wrote K's and Vᵀ's hi and lo to global
//     memory read twice the bytes from L2 at every stage; one that wrote Vᵀ
//     alone cost 4-22 µs a launch in its own traffic: PERF.md §6.)
//     At D = 128 the splits and the wgmmas' operand reads share the SM's
//     shared-memory bandwidth, which bounds a sub-tile there;
//   * P comes from the S accumulators as the A operand, split hi + lo. Its
//     fragment holds each thread's columns 2·t4 and 2·t4 + 1 of a k-step at
//     k = t4 and t4 + 4, so each group of 8 keys of Vᵀ is written in that
//     order (`sea::key_at`): no shuffle in the consumers;
//   * shared memory: a 64-row float32 tile is 256·D bytes, doubled by hi and
//     lo. So the width decides the block (`tf::Config`): at D = 32 and 64
//     two consumer warpgroups (128 rows) and two K/Vᵀ stages, 115848 and
//     222344 bytes; at 80 two warpgroups and one stage, 193616; at 128 one
//     warpgroup and one stage, the mask words read through L1, 230480 (plus
//     the lists). K and
//     Vᵀ have barriers of their own, so a stage's K is refilled while its Vᵀ
//     is read, and the next V lands while this one is read; each warpgroup
//     waits for its P·V before the next sub-tile, as one stage needs;
//   * at D = 80, whose 320-byte rows no 128-byte box tiles, Q, K and V take
//     8-column panels under the 32-byte swizzle (`sea::TPanels`), the bytes
//     of the bf16 tiles' 16-column ones.
// One block per (batch·head, 64- or 128-row q-tile), every head's last
// q-tile first; t_dst a multiple of the block's rows (the wrappers pad T to
// 128). Registers: 128 for the 512-thread launches (D = 32, 64, 80; consumers
// under 216 after setmaxnreg), 168 for the 384-thread ones (D = 128;
// consumers under 232), the producers under 40; no spill.
// K5's float32 instance keeps the body that served every float32 instance
// before (`causal_flat_kernel`, FlashAttention-2's on mma.sync): at BERT's
// short rows it was faster (see there).
//
// K6 walks the same lists restricted to one window: the ring launches it S
// times per shard (S² per layer), each over a 1/S slice of the columns, so
// its bound and its design are K2's on a smaller problem. K5 takes the same
// design; its padded columns past each example's length are skipped whole
// sub-tiles at a time. Its bound is bytes as well.
//
// The impl variants K9a-c. The TPU kernels select each element's packed mask
// word with a chain of vector selects over all T_M/32 words, the largest
// vector block of the flat kernel; their variants cut that chain. What
// carries over here is which words a tile may read and which pieces it may
// skip. Each variant keeps K1's element mask bit for bit: the restriction
// only decides which words or pieces are read, and a word it leaves out
// counts as dead.
//   * K9a (WORD_RANGE) reads only the words of the tile's word range wr =
//     lo | hi << 8 | exact << 16 (`_tile_word_ranges`: corner evaluation
//     padded by one pixel, so the few-ulp gap between the TPU's reciprocal
//     form and the division form stays inside it), from the block's staged
//     words.
//   * K9b (WORD_LOOP) keeps no shared-memory copy of the mask words: the
//     range's words are read through L1.
//   * K9c (SUBTILE) walks outer k-blocks (`block_k`, the JAX package's
//     auto_block width) and visits only the `sub`-wide pieces whose bit is
//     set in the tile's `submask` (`tile_activity_sub`), skipping the loads,
//     Q·Kᵀ, the predicate and P·V of every other piece.
// Every variant walks the listed 64-column sub-tiles in increasing order
// through the same body, and a sub-tile with no alive element changes
// nothing, so each equals K1's output bit for bit on the same inputs. Their
// bound is K1's, by bytes.
//
// Head widths. Each entry point instantiates the widths of its list
// (`sea::dispatch` over sea_mask.cuh's FORWARD_WIDTHS, TRAIN_WIDTHS,
// BIDIR_WIDTHS, BASE_WIDTHS): K1 at 32 (the scaling sweep's 4 heads of 32),
// 64, 80 (OPT-2.7b) and 128 (LLaMA-7b and 13b), K2 at 64, 80 and 128, K5 at
// 32 (LRA's image task) and 64, K6 (K2's instance at 64) and K9a-c at 64,
// each in both types. Width 32 is the other widths' body at N = 32 (wgmma
// m64n32k16 and m64n32k8 for P·V, two k-steps of Q·Kᵀ in bf16, four in
// TF32); it is a correct instance, not yet a tuned one.
//
// The debug kernels `alive_mask_kernel` and `impl_alive_mask_kernel` build
// the bf16 body's alive words, so that the card checks them bit for bit
// against the oracle, and `word_check_kernel` holds the construction to the
// per-column pixel map on every row width to 2^17.

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

constexpr float M_INIT = -1.0e30f;  // running-max floor: exp(-inf - m) == 0

// Which mask words the causal element predicate reads: all of the row's
// (K1, K2, K5, K6), the tile's word range staged (K9a) or walked (K9b), or
// the words of the active pieces only (K9c).
enum Impl : int { FLAT = 0, WORD_RANGE = 1, WORD_LOOP = 2, SUBTILE = 3 };

// ---------------------------------------------------------------------------
// The bf16 body on wgmma (K1, K2, K5, K6, K9a-c in bfloat16)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int STAGES = 4;                  // K/V sub-tiles in flight
constexpr int CONSUMERS = 2;               // warpgroups of 64 query rows each
constexpr int BQ = 64 * CONSUMERS;         // query rows per block
constexpr int THREADS = 128 * (CONSUMERS + 1);
// setmaxnreg: the producer warpgroup gives up registers, the consumers take
// them (40·128 + 232·256 <= 65536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_MAX = 232448;           // what a block may take on the H100

// Shared memory from a 1024-byte aligned base: Q (one 64-row tile per
// consumer warpgroup), the STAGES K/V stages (K then V), the block's mask
// words, the barriers, each stage's walk entry (c0 and each warpgroup's list
// entry, -1 where the sub-tile is dead for it), then the two warpgroups'
// lists (and, K9a-c, their `tiles` entries), sized at launch. Each 64-row
// tile is sea::Panels<D> (sea_mma.cuh): a 128-byte swizzle at D = 64 and
// 128, a 32-byte one at D = 32 and 80.
template <int D>
struct Layout : sea::Panels<D> {
  using P = sea::Panels<D>;
  static constexpr int Q_BYTES = CONSUMERS * P::TILE;
  static constexpr int STAGE_OFF = Q_BYTES;
  static constexpr int STAGE = 2 * P::TILE;
  static constexpr int WORDS_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int BAR_OFF = WORDS_OFF + BQ * MAX_WORDS * 4;
  static constexpr int META_OFF = BAR_OFF + 8 * (2 * STAGES + 1);
  static constexpr int LIST_OFF = META_OFF + 16 * STAGES;
  static constexpr int FIXED = LIST_OFF + 1024;  // and the base's alignment
};

// One consumer warpgroup's walk over its q-block's list (staged in shared
// memory): entry e, sub-tile c (first column), and where its rows end.
struct Walk {
  int e, c, cnt, end;
  const int* lst;
  const int* aux;
};

// Advance w to the first visited sub-tile at or after (e, c); false when
// the list is done. The same walk as the float32 body's.
template <int IMPL>
__device__ __forceinline__ bool seek(Walk& w, int block_k, int col_stop, int sub) {
  for (; w.e < w.cnt; ++w.e, w.c = -1) {
    const int start = w.lst[w.e] * block_k;
    for (w.c = w.c < start ? start : w.c; w.c < start + block_k; w.c += 64) {
      if (w.c >= w.end || w.c >= col_stop) break;
      if (IMPL == SUBTILE && ((((unsigned)w.aux[w.e]) >> ((w.c - start) / sub)) & 1u) == 0u)
        continue;
      return true;
    }
  }
  return false;
}

// The max (MAX) or the sum of a thread's 16 values of one row, pairwise in
// a fixed order.
template <bool MAX>
__device__ __forceinline__ float tree(float (&t)[16]) {
  auto op = [](float a, float b) { return MAX ? fmaxf(a, b) : a + b; };
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = op(t[j], t[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = op(t[j], t[j + 4]);
  t[0] = op(t[0], t[2]);
  t[1] = op(t[1], t[3]);
  return op(t[0], t[1]);
}

}  // namespace wg

template <int D, bool STATS, bool BIDIR, int IMPL = FLAT>
__global__ void __launch_bounds__(wg::THREADS, 1) causal_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const uint32_t* __restrict__ mbits,
    const float* __restrict__ scaler, const int* __restrict__ counts,
    const int* __restrict__ idx, const int* __restrict__ tiles,
    const int* __restrict__ rowbase, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int t_dst, int t_src, int t_m,
    int n_words, int block_q, int block_k, int nq, int nkb, int sub, float oversample,
    float k_cfg, float keep_lo, float keep_hi, int col_base) {
  using L = wg::Layout<D>;
  constexpr int STAGES = wg::STAGES;
  constexpr int LIST = IMPL == FLAT ? 1 : 2;  // a list's ints per entry
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sea::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR_OFF;   // stage s landed: full + 8·s
  const uint32_t empty = full + 8 * STAGES;  // stage s released by both warpgroups
  const uint32_t qbar = empty + 8 * STAGES;  // Q and the mask words landed
  int* meta = reinterpret_cast<int*>(smem + L::META_OFF);
  int* lists = reinterpret_cast<int*>(smem + L::LIST_OFF);

  // blocks start with every head's last (heaviest causal) q-tile
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * wg::BQ;  // first local row of the tile
  const int tid = threadIdx.x;
  const int len = BIDIR ? lengths[bh] : 0;
  // k and v hold the (global) columns col_base .. col_stop − 1
  const int col_stop = col_base + t_src;
  // warpgroup w's rows: q-block, first global row, and its list in shared memory
  auto qblock = [&](int w) { return (row0 + 64 * w) / block_q; };
  auto first_row = [&](int w) {
    const int lr = row0 + 64 * w;
    return BIDIR ? lr : rowbase[qblock(w)] + (lr - qblock(w) * block_q);
  };
  auto walk = [&](int w) {
    const int* l = lists + w * LIST * nkb;
    return wg::Walk{0, -1, counts[bh * nq + qblock(w)], BIDIR ? len : first_row(w) + 64, l,
                    l + nkb};
  };

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
      sea::mbar_arrive_expect_tx(qbar, L::Q_BYTES + (IMPL != WORD_LOOP ? wg::BQ * n_words * 4 : 0));
      for (int w = 0; w < wg::CONSUMERS; ++w)
        for (int p = 0; p < L::NP; ++p)
          sea::tma_load_2d(base + w * L::TILE + p * L::PANEL, &tq, qbar, p * L::PW,
                           bh * t_dst + row0 + 64 * w);
      if (IMPL != WORD_LOOP)
        sea::bulk_load(base + L::WORDS_OFF, mbits + ((long)bh * t_dst + row0) * n_words,
                       wg::BQ * n_words * 4, qbar);
    }
    for (int w = 0; w < wg::CONSUMERS; ++w) {
      const long off = ((long)bh * nq + qblock(w)) * nkb;
      const int cnt = counts[bh * nq + qblock(w)];
      int* l = lists + w * LIST * nkb;
      for (int i = tid; i < cnt; i += 32) {
        l[i] = idx[off + i];
        if (IMPL != FLAT) l[nkb + i] = tiles[off + i];
      }
    }
    __syncwarp();
    if (tid != 0) return;
    // The walk: the union of the two warpgroups' sub-tiles in increasing
    // order, each stage tagged with each warpgroup's list entry (-1: dead
    // for it).
    wg::Walk w0 = walk(0), w1 = walk(1);
    bool h0 = wg::seek<IMPL>(w0, block_k, col_stop, sub);
    bool h1 = wg::seek<IMPL>(w1, block_k, col_stop, sub);
    for (int it = 0;; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) sea::mbar_wait(empty + 8 * st, ((it / STAGES) + 1) & 1);
      int* m = meta + 4 * st;
      if (!h0 && !h1) {
        m[0] = -1;
        sea::mbar_arrive(full + 8 * st);
        break;
      }
      const int c0 = !h1 || (h0 && w0.c <= w1.c) ? w0.c : w1.c;
      m[0] = c0;
      m[1] = h0 && w0.c == c0 ? w0.e : -1;
      m[2] = h1 && w1.c == c0 ? w1.e : -1;
      if (m[1] >= 0) {
        w0.c += 64;
        h0 = wg::seek<IMPL>(w0, block_k, col_stop, sub);
      }
      if (m[2] >= 0) {
        w1.c += 64;
        h1 = wg::seek<IMPL>(w1, block_k, col_stop, sub);
      }
      sea::mbar_arrive_expect_tx(full + 8 * st, L::STAGE);
      const uint32_t ks = base + L::STAGE_OFF + st * L::STAGE;
      const int krow = bh * t_src + c0 - col_base;
      for (int p = 0; p < L::NP; ++p) {
        sea::tma_load_2d(ks + p * L::PANEL, &tk, full + 8 * st, p * L::PW, krow);
        sea::tma_load_2d(ks + L::TILE + p * L::PANEL, &tv, full + 8 * st, p * L::PW, krow);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, 16 a warp; a thread holds rows g
  // and g + 8 of its warp's (h = 0, 1) and, of each, the columns 8·j +
  // 2·t4 + {0, 1} of every 64-column accumulator.
  sea::setmaxnreg_inc<wg::CONSUMER_REGS>();
  const int cw = tid / 128 - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lrow0 = row0 + 64 * cw;  // the warpgroup's first local row
  const int grow0 = first_row(cw);
  const int* aux = lists + cw * LIST * nkb + nkb;  // its `tiles` entries (K9a-c)
  const uint32_t* Ms = reinterpret_cast<const uint32_t*>(smem + L::WORDS_OFF);

  // per row h: its mask words, last live column and width (causal r + 1,
  // bidirectional the length) for the alive words
  float m_i[2], l_i[2], ps[2], thr[2];
  sea::AliveRow rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 16 * warp + g + 8 * h;
    const int r = grow0 + rl;
    m_i[h] = M_INIT;
    l_i[h] = 0.f;
    const float wf = BIDIR ? (float)len : (float)(r + 1);
    rows[h] = sea::AliveRow{IMPL == WORD_LOOP ? mbits + ((long)bh * t_dst + lrow0 + rl) * n_words
                                              : Ms + (64 * cw + rl) * n_words,
                            BIDIR ? len - 1 : r, wf, sea::recip(wf), __fdiv_rn((float)t_m, wf),
                            __fdiv_rn(wf, (float)t_m)};
    const float w = (float)(r + 1);
    ps[h] = fmaxf(floorf(__fadd_rn(__fdiv_rn(w, oversample), 0.5f)), 1.0f);
    const float oys = __fdiv_rn(fminf(fmaxf(w, keep_lo), keep_hi), k_cfg);
    thr[h] = __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, oys), 0.5f), 1e-4f);
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const bool undersample = !STATS && !BIDIR && oversample != 1.0f;
  const float dead = __uint_as_float(0xff800000u);  // -inf
  const uint32_t qs = base + cw * L::TILE;

  // P·V of one sub-tile stays in flight while the next one's Q·Kᵀ and alive
  // words run: `pending` is its stage, released once it has completed, and
  // ph, pl are its A fragments, kept until then
  uint32_t ph[4][4], pl[4][4];
  int pending = -1;

  sea::mbar_wait(qbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    sea::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    const int c0 = meta[4 * st];
    if (c0 < 0) break;
    const int e = meta[4 * st + 1 + cw];
    // a sub-tile not in this warpgroup's list is dead for its rows: it
    // would leave m, l and acc as they are, so it is skipped
    if (e < 0) {
      sea::wgmma_wait<0>();
      sea::fence_regs(acc);
      sea::fence_frags(ph);
      sea::fence_frags(pl);
      __syncwarp();
      if (lane == 0) {
        if (pending >= 0) sea::mbar_arrive(empty + 8 * pending);
        sea::mbar_arrive(empty + 8 * st);
      }
      pending = -1;
      continue;
    }
    const uint32_t ks = base + L::STAGE_OFF + st * L::STAGE, vs = ks + L::TILE;
    // S = Q·Kᵀ, issued; the rows' alive words are built while it (and the
    // previous P·V) run
    float s[32];
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sea::wgmma_ss_n64(s, L::kdesc(qs, kk), L::kdesc(ks, kk), kk > 0);
    sea::wgmma_commit();
    int wlo = 0, whi = n_words - 1;
    if (IMPL == WORD_RANGE || IMPL == WORD_LOOP) {
      const sea::WordRange r = sea::word_range(aux[e]);
      wlo = r.lo;
      whi = r.hi;
    }
    uint64_t bits[2];
    sea::alive_bits<BIDIR, IMPL == WORD_LOOP>(rows, c0, t_m, wlo, whi, t4, bits);
    if (undersample) {
      // the keep-predicate on this thread's own columns only, the ones it
      // tests
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint64_t keep = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * (j >> 1) + 2 * t4 + (j & 1);
          keep |= (uint64_t)sea::keep_quot(sea::quot((float)(c0 + c + 1), rows[h].w, rows[h].y),
                                           ps[h], thr[h])
                  << c;
        }
        bits[h] &= keep;
      }
    }
    // S, and the previous P·V, have completed: its stage is released
    sea::wgmma_wait<0>();
    sea::fence_regs(s);
    sea::fence_regs(acc);
    sea::fence_frags(ph);
    sea::fence_frags(pl);
    __syncwarp();
    if (lane == 0 && pending >= 0) sea::mbar_arrive(empty + 8 * pending);

    // the bit test per element, then the online softmax, row by row
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t a = bits[h] >> (2 * t4);
      float t[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float& x = s[4 * (j >> 1) + 2 * h + (j & 1)];
        x = (a >> (8 * (j >> 1) + (j & 1))) & 1u ? x : dead;
        t[j] = x;
      }
      float rmax = wg::tree<true>(t);
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m_i[h], rmax);
      // a row whose max did not move gets corr = 2^0 = 1 exactly
      corr[h] = exp2_sfu(__fmul_rn(__fsub_rn(m_i[h], m_new), LOG2E));
      const float ml = __fmul_rn(m_new, LOG2E);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float& x = s[4 * (j >> 1) + 2 * h + (j & 1)];
        x = exp2_sfu(__fmaf_rn(x, LOG2E, -ml));  // 2^-inf == 0: dead elements
        t[j] = x;
      }
      float psum = wg::tree<false>(t);
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[h] = l_i[h] * corr[h] + psum;
      m_i[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] *= corr[i / 2];
    // P = P_hi + P_lo in bf16, the A fragments straight from the S
    // accumulators
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_bf16(s[2 * i], s[2 * i + 1], ph[i / 4][i % 4], pl[i / 4][i % 4]);

    // acc += P·V, two wgmmas per 16 columns, left in flight
    sea::fence_regs(acc);
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = L::mndesc(vs, kk);
      sea::wgmma_rs<D>(acc, pl[kk], vd);
      sea::wgmma_rs<D>(acc, ph[kk], vd);
    }
    sea::wgmma_commit();
    pending = st;
  }
  sea::wgmma_wait<0>();
  sea::fence_regs(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long row = (long)bh * t_dst + lrow0 + 16 * warp + g + 8 * h;
    const float l = l_i[h];
    const float safe_l = l > 0.f ? l : 1.f;
    const float sc = scaler ? scaler[row] : 1.f;
    __nv_bfloat16* o = out + row * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] / safe_l * sc, acc[4 * j + 2 * h + 1] / safe_l * sc);
    if (STATS && t4 == 0)
      lse[row] = l > 0.f ? m_i[h] + logf(l) : __uint_as_float(0x7f800000u);
  }
}

// ---------------------------------------------------------------------------
// The float32 body on wgmma in split TF32 (K1, K2, K5, K6, K9a-c in float32)
// ---------------------------------------------------------------------------

namespace tf {

// Consumer warpgroups (64 query rows each), K/Vᵀ stages and where the mask
// words live, by head width, as a block's 227 KiB of shared memory hold them
// with every operand in hi and lo (see Layout): at D = 32 and 64 two
// warpgroups and two stages; at 80 two and one; at 128 one and one, the
// words read through L1. At 32 a block takes 113 KiB: more stages would fit,
// but the one raw-V slot paces the stages (a V sub-tile is transposed before
// the next lands), and 64's proven two are kept; a second block would not
// fit the SM's registers (512 threads of 128). Two producer warpgroups: one
// warp issues the copies, the other seven split. setmaxnreg moves the
// producers' registers to the consumers: 2·40 + 2·216 of one 512-thread
// block's 128 a thread, or 2·40 + 232 of one 384-thread block's 168.
template <int D>
struct Config {
  static constexpr int CONSUMERS = D == 128 ? 1 : 2;
  static constexpr int STAGES = D <= 64 ? 2 : 1;
  static constexpr bool WORDS_SMEM = D != 128;
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per block
  static constexpr int PRODUCERS = 256;      // threads of the producer warpgroups
  static constexpr int SPLITTERS = PRODUCERS / 32 - 1;  // their warps that split
  static constexpr int THREADS = PRODUCERS + 128 * CONSUMERS;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 216 : 232;
};

// Shared memory from a 1024-byte aligned base: each consumer warpgroup's Q
// (hi, then lo; 64 x D), the STAGES stages' K (hi, lo; 64 x D) and Vᵀ (hi,
// lo; D x 64), the slot where each V sub-tile (64 x D) lands raw, the
// block's mask words (WORDS_SMEM), the barriers (per stage: K landed, K
// split, K released, Vᵀ split, Vᵀ released; the raw V landed and consumed;
// Q landed), each stage's walk entry, then the lists, sized at launch. A Q,
// K or V tile (64 x D) and a Vᵀ tile (D x 64) are 256·D bytes each.
template <int D>
struct Layout {
  using QT = sea::TPanels<64, D>;  // a q-tile, K or V sub-tile, read K-major along D
  using VT = sea::TPanels<D, 64>;  // a Vᵀ sub-tile, read K-major along its 64 keys
  using C = Config<D>;
  static_assert(QT::TILE == VT::TILE, "V and Vᵀ tiles alike");
  static constexpr int TILE = QT::TILE;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + C::CONSUMERS * 2 * TILE;
  static constexpr int V_OFF = K_OFF + C::STAGES * 2 * TILE;
  static constexpr int RAW_OFF = V_OFF + C::STAGES * 2 * TILE;
  static constexpr int WORDS_OFF = RAW_OFF + TILE;
  static constexpr int BAR_OFF = WORDS_OFF + (C::WORDS_SMEM ? C::BQ * MAX_WORDS * 4 : 0);
  static constexpr int META_OFF = BAR_OFF + 8 * (5 * C::STAGES + 3);
  static constexpr int LIST_OFF = META_OFF + 16 * C::STAGES;
  static constexpr int FIXED = LIST_OFF + 1024;  // and the base's alignment
};

// A tile of BYTES raw floats split in place by `threads` threads (this one
// `i0`): TF32 hi over the raw values and lo in the BYTES after them, each
// rounded as cvt.rna rounds it (`split_tf32_rna`), in the layout TMA wrote
// (the split is elementwise); then made visible to wgmma's reads.
template <int BYTES>
__device__ __forceinline__ void split_tile(unsigned char* tile, int i0, int threads) {
  uint4* hi = reinterpret_cast<uint4*>(tile);
#pragma unroll 2
  for (int i = i0; i < BYTES / 16; i += threads) {
    uint4 x = hi[i], lo;
    uint32_t* v = reinterpret_cast<uint32_t*>(&x);
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int j = 0; j < 4; ++j) sea::split_tf32_rna(__uint_as_float(v[j]), v[j], l[j]);
    hi[i] = x;
    hi[BYTES / 16 + i] = lo;
  }
  sea::fence_proxy_async();
}

// A raw V sub-tile (64 keys x D, as TMA laid it out: `Layout::QT`) written
// as Vᵀ (D x 64, `Layout::VT`) in TF32 hi at `hi` and lo after it, the keys
// of each group of 8 in `key_at`'s order, by `warps` warps (this one `w`).
// A warp takes 32 key positions of one 4-wide column chunk: each lane reads
// its key's 16 bytes and writes its position in 4 rows of Vᵀ, both without
// bank conflicts under the swizzles. Then made visible to wgmma's reads.
template <int D>
__device__ __forceinline__ void transpose_tile(const unsigned char* raw, unsigned char* hi, int w,
                                               int warps, int lane) {
  using QT = typename Layout<D>::QT;
  using VT = typename Layout<D>::VT;
  for (int item = w; item < 2 * (D / 4); item += warps) {
    const int pos = 32 * (item & 1) + lane, d0 = 4 * (item >> 1);
    const int key = (pos & ~7) + sea::key_at(pos & 7);
    const uint4 x = *reinterpret_cast<const uint4*>(
        raw + (d0 / QT::PW) * QT::PANEL +
        sea::swizzled<QT::ROW>(key * QT::ROW + (d0 % QT::PW) * 4));
    const float xs[4] = {__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
                         __uint_as_float(x.w)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t h, l;
      sea::split_tf32_rna(xs[q], h, l);
      const uint32_t o = (pos / VT::PW) * VT::PANEL +
                         sea::swizzled<VT::ROW>((d0 + q) * VT::ROW + (pos % VT::PW) * 4);
      *reinterpret_cast<uint32_t*>(hi + o) = h;
      *reinterpret_cast<uint32_t*>(hi + VT::TILE + o) = l;
    }
  }
  sea::fence_proxy_async();
}

}  // namespace tf

// The float32 body: `causal_wgmma_kernel`'s skeleton (the walk, the TMA
// copies on mbarriers, the alive words, the softmax and the epilogue) with
// every product in split TF32 on wgmma, a·b = a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi per 8-wide k-step, small terms first (a_lo·b_lo dropped, about
// 2^-21 of a product). S = Q·Kᵀ reads Q and K from shared memory (SS,
// m64n64k8); P·V takes P from registers, split as the S accumulators stand,
// and Vᵀ from shared memory (RS, m64nDk8). Every operand lands raw and is
// split on the chip: Q by its warpgroup once, in place; each K sub-tile in
// place in its stage, and each V sub-tile from the slot where it lands,
// transposed into its stage's Vᵀ, by the producer warpgroups' seven warps
// that issue no copy. K and Vᵀ have barriers of their own, so that a
// stage's K is refilled while its Vᵀ is read, and the next V is in flight
// while this one is.
template <int D, bool STATS, bool BIDIR, int IMPL = FLAT>
__global__ void __launch_bounds__(tf::Config<D>::THREADS, 1) causal_tf32_wgmma_kernel(
        const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const uint32_t* __restrict__ mbits,
        const float* __restrict__ scaler, const int* __restrict__ counts,
        const int* __restrict__ idx, const int* __restrict__ tiles,
        const int* __restrict__ rowbase, const int* __restrict__ lengths,
        float* __restrict__ out, float* __restrict__ lse, int t_dst, int t_src, int t_m,
        int n_words, int block_q, int block_k, int nq, int nkb, int sub, float oversample,
        float k_cfg, float keep_lo, float keep_hi, int col_base) {
  using C = tf::Config<D>;
  using L = tf::Layout<D>;
  using QT = typename L::QT;
  using VT = typename L::VT;
  constexpr int STAGES = C::STAGES, CONSUMERS = C::CONSUMERS;
  constexpr int LIST = IMPL == FLAT ? 1 : 2;  // a list's ints per entry
  constexpr bool WORDS_SMEM = C::WORDS_SMEM && IMPL != WORD_LOOP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sea::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t kland = base + L::BAR_OFF;     // stage s's raw K landed: kland + 8·s
  const uint32_t kfull = kland + 8 * STAGES;    // its K split by the splitter warps
  const uint32_t kempty = kfull + 8 * STAGES;   // its K released by every consumer warp
  const uint32_t vfull = kempty + 8 * STAGES;   // its Vᵀ written
  const uint32_t vempty = vfull + 8 * STAGES;   // its Vᵀ released
  const uint32_t vland = vempty + 8 * STAGES;   // the raw V landed
  const uint32_t vtaken = vland + 8;            // the raw V transposed, its slot free
  const uint32_t qbar = vtaken + 8;             // Q and the mask words landed
  int* meta = reinterpret_cast<int*>(smem + L::META_OFF);
  int* lists = reinterpret_cast<int*>(smem + L::LIST_OFF);

  // blocks start with every head's last (heaviest causal) q-tile
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // first local row of the tile
  const int tid = threadIdx.x;
  const int len = BIDIR ? lengths[bh] : 0;
  // k and v hold the (global) columns col_base .. col_stop − 1
  const int col_stop = col_base + t_src;
  // warpgroup w's rows: q-block, first global row, and its list in shared memory
  auto qblock = [&](int w) { return (row0 + 64 * w) / block_q; };
  auto first_row = [&](int w) {
    const int lr = row0 + 64 * w;
    return BIDIR ? lr : rowbase[qblock(w)] + (lr - qblock(w) * block_q);
  };
  auto walk = [&](int w) {
    const int* l = lists + w * LIST * nkb;
    return wg::Walk{0, -1, counts[bh * nq + qblock(w)], BIDIR ? len : first_row(w) + 64, l,
                    l + nkb};
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sea::mbar_init(kland + 8 * s, 1);
      sea::mbar_init(kfull + 8 * s, C::SPLITTERS);  // one arrival per splitter warp
      sea::mbar_init(kempty + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
      sea::mbar_init(vfull + 8 * s, C::SPLITTERS);
      sea::mbar_init(vempty + 8 * s, 4 * CONSUMERS);
    }
    sea::mbar_init(vland, 1);
    sea::mbar_init(vtaken, C::SPLITTERS);
    sea::mbar_init(qbar, 1);
    sea::mbar_fence_init();
  }
  __syncthreads();

  if (tid < C::PRODUCERS) {
    // The producer warpgroups: lane 0 of warp 0 issues every copy, warp 0
    // stages the lists first; the other warps split.
    sea::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid >= 32) {
      // Sub-tile it: its K, in place, as it lands (the walk's end where its
      // entry is -1); then its V, from the raw slot into the stage's Vᵀ once
      // the consumers have released what the stage held.
      const int sw = (tid >> 5) - 1, lane = tid & 31;
      for (int it = 0;; ++it) {
        const int st = it % STAGES;
        sea::mbar_wait(kland + 8 * st, (it / STAGES) & 1);
        const bool done = meta[4 * st] < 0;
        if (!done)
          tf::split_tile<L::TILE>(smem + L::K_OFF + st * 2 * L::TILE, tid - 32, 32 * C::SPLITTERS);
        __syncwarp();
        if (lane == 0) sea::mbar_arrive(kfull + 8 * st);
        if (done) return;
        sea::mbar_wait(vland, it & 1);
        if (it >= STAGES) sea::mbar_wait(vempty + 8 * st, ((it / STAGES) + 1) & 1);
        tf::transpose_tile<D>(smem + L::RAW_OFF, smem + L::V_OFF + st * 2 * L::TILE, sw,
                              C::SPLITTERS, lane);
        __syncwarp();
        if (lane == 0) {
          sea::mbar_arrive(vfull + 8 * st);
          sea::mbar_arrive(vtaken);
        }
      }
    }
    if (tid == 0) {
      // Q of the warpgroups whose lists are not empty (K5's padded rows have
      // none)
      int live = 0;
      for (int w = 0; w < CONSUMERS; ++w) live += counts[bh * nq + qblock(w)] > 0;
      sea::mbar_arrive_expect_tx(qbar, live * L::TILE + (WORDS_SMEM ? C::BQ * n_words * 4 : 0));
      for (int w = 0; w < CONSUMERS; ++w)
        if (counts[bh * nq + qblock(w)] > 0)
          for (int p = 0; p < QT::NP; ++p)
            sea::tma_load_2d(base + L::Q_OFF + w * 2 * L::TILE + p * QT::PANEL, &tq, qbar,
                             p * QT::PW, bh * t_dst + row0 + 64 * w);
      if (WORDS_SMEM)
        sea::bulk_load(base + L::WORDS_OFF, mbits + ((long)bh * t_dst + row0) * n_words,
                       C::BQ * n_words * 4, qbar);
    }
    for (int w = 0; w < CONSUMERS; ++w) {
      const long off = ((long)bh * nq + qblock(w)) * nkb;
      const int cnt = counts[bh * nq + qblock(w)];
      int* l = lists + w * LIST * nkb;
      for (int i = tid; i < cnt; i += 32) {
        l[i] = idx[off + i];
        if (IMPL != FLAT) l[nkb + i] = tiles[off + i];
      }
    }
    __syncwarp();
    if (tid != 0) return;
    // The walk: the union of the warpgroups' sub-tiles in increasing order,
    // each stage tagged with each warpgroup's list entry (-1: dead for it).
    wg::Walk w0 = walk(0), w1 = CONSUMERS > 1 ? walk(1) : w0;
    bool h0 = wg::seek<IMPL>(w0, block_k, col_stop, sub);
    bool h1 = CONSUMERS > 1 && wg::seek<IMPL>(w1, block_k, col_stop, sub);
    for (int it = 0;; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) sea::mbar_wait(kempty + 8 * st, ((it / STAGES) + 1) & 1);
      int* m = meta + 4 * st;
      if (!h0 && !h1) {
        m[0] = -1;
        sea::mbar_arrive(kland + 8 * st);
        break;
      }
      const int c0 = !h1 || (h0 && w0.c <= w1.c) ? w0.c : w1.c;
      m[0] = c0;
      m[1] = h0 && w0.c == c0 ? w0.e : -1;
      m[2] = h1 && w1.c == c0 ? w1.e : -1;
      if (m[1] >= 0) {
        w0.c += 64;
        h0 = wg::seek<IMPL>(w0, block_k, col_stop, sub);
      }
      if (m[2] >= 0) {
        w1.c += 64;
        h1 = wg::seek<IMPL>(w1, block_k, col_stop, sub);
      }
      // raw K into the stage's hi half, raw V into the slot once the last
      // one was taken
      const int krow = bh * t_src + c0 - col_base;
      sea::mbar_arrive_expect_tx(kland + 8 * st, L::TILE);
      for (int p = 0; p < QT::NP; ++p)
        sea::tma_load_2d(base + L::K_OFF + st * 2 * L::TILE + p * QT::PANEL, &tk, kland + 8 * st,
                         p * QT::PW, krow);
      if (it > 0) sea::mbar_wait(vtaken, (it - 1) & 1);
      sea::mbar_arrive_expect_tx(vland, L::TILE);
      for (int p = 0; p < QT::NP; ++p)
        sea::tma_load_2d(base + L::RAW_OFF + p * QT::PANEL, &tv, vland, p * QT::PW, krow);
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, 16 a warp; a thread holds rows g
  // and g + 8 of its warp's (h = 0, 1) and, of each, the columns 8·j +
  // 2·t4 + {0, 1} of every accumulator.
  sea::setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = (tid - C::PRODUCERS) / 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lrow0 = row0 + 64 * cw;  // the warpgroup's first local row
  const int grow0 = first_row(cw);
  const int* aux = lists + cw * LIST * nkb + nkb;  // its `tiles` entries (K9a-c)
  const uint32_t* Ms = reinterpret_cast<const uint32_t*>(smem + L::WORDS_OFF);

  // per row h: its mask words, last live column and width (causal r + 1,
  // bidirectional the length) for the alive words
  float m_i[2], l_i[2], ps[2], thr[2];
  sea::AliveRow rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 16 * warp + g + 8 * h;
    const int r = grow0 + rl;
    m_i[h] = M_INIT;
    l_i[h] = 0.f;
    const float wf = BIDIR ? (float)len : (float)(r + 1);
    rows[h] = sea::AliveRow{WORDS_SMEM ? Ms + (64 * cw + rl) * n_words
                                       : mbits + ((long)bh * t_dst + lrow0 + rl) * n_words,
                            BIDIR ? len - 1 : r, wf, sea::recip(wf), __fdiv_rn((float)t_m, wf),
                            __fdiv_rn(wf, (float)t_m)};
    const float w = (float)(r + 1);
    ps[h] = fmaxf(floorf(__fadd_rn(__fdiv_rn(w, oversample), 0.5f)), 1.0f);
    const float oys = __fdiv_rn(fminf(fmaxf(w, keep_lo), keep_hi), k_cfg);
    thr[h] = __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, oys), 0.5f), 1e-4f);
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const bool undersample = !STATS && !BIDIR && oversample != 1.0f;
  const float dead = __uint_as_float(0xff800000u);  // -inf
  const uint32_t qhi = base + L::Q_OFF + cw * 2 * L::TILE, qlo = qhi + L::TILE;

  // Q lands raw; the warpgroup splits it once, in place, before any wgmma
  // reads it (a warpgroup whose list is empty has none)
  sea::mbar_wait(qbar, 0);
  if (counts[bh * nq + qblock(cw)] > 0)
    tf::split_tile<L::TILE>(smem + L::Q_OFF + cw * 2 * L::TILE, tid & 127, 128);
  sea::bar_sync(1 + cw, 128);

  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    sea::mbar_wait(kfull + 8 * st, par);
    const int c0 = meta[4 * st];
    if (c0 < 0) break;
    const int e = meta[4 * st + 1 + cw];
    // a sub-tile not in this warpgroup's list is dead for its rows: it would
    // leave m, l and acc as they are, so it is skipped. Its Vᵀ is released
    // only once written, so that no warp's release runs a phase ahead of the
    // warpgroup that reads it.
    if (e < 0) {
      __syncwarp();
      if (lane == 0) sea::mbar_arrive(kempty + 8 * st);
      sea::mbar_wait(vfull + 8 * st, par);
      __syncwarp();
      if (lane == 0) sea::mbar_arrive(vempty + 8 * st);
      continue;
    }
    const uint32_t ks = base + L::K_OFF + st * 2 * L::TILE;
    const uint32_t vs = base + L::V_OFF + st * 2 * L::TILE;
    // S = Q·Kᵀ in split TF32, issued; the rows' alive words are built while
    // it runs
    float s[32];
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      sea::wgmma_tf32_ss_n64(s, QT::kdesc(qlo, kk), QT::kdesc(ks, kk), kk > 0);
      sea::wgmma_tf32_ss_n64(s, QT::kdesc(qhi, kk), QT::kdesc(ks + QT::TILE, kk), 1);
      sea::wgmma_tf32_ss_n64(s, QT::kdesc(qhi, kk), QT::kdesc(ks, kk), 1);
    }
    sea::wgmma_commit();
    int wlo = 0, whi = n_words - 1;
    if (IMPL == WORD_RANGE || IMPL == WORD_LOOP) {
      const sea::WordRange r = sea::word_range(aux[e]);
      wlo = r.lo;
      whi = r.hi;
    }
    uint64_t bits[2];
    sea::alive_bits<BIDIR, !WORDS_SMEM>(rows, c0, t_m, wlo, whi, t4, bits);
    if (undersample) {
      // the keep-predicate on this thread's own columns only, the ones it
      // tests
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint64_t keep = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * (j >> 1) + 2 * t4 + (j & 1);
          keep |= (uint64_t)sea::keep_quot(sea::quot((float)(c0 + c + 1), rows[h].w, rows[h].y),
                                           ps[h], thr[h])
                  << c;
        }
        bits[h] &= keep;
      }
    }
    // S has completed: the stage's K is released
    sea::wgmma_wait<0>();
    sea::fence_regs(s);
    __syncwarp();
    if (lane == 0) sea::mbar_arrive(kempty + 8 * st);

    // the bit test per element, then the online softmax, row by row
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t a = bits[h] >> (2 * t4);
      float t[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float& x = s[4 * (j >> 1) + 2 * h + (j & 1)];
        x = (a >> (8 * (j >> 1) + (j & 1))) & 1u ? x : dead;
        t[j] = x;
      }
      float rmax = wg::tree<true>(t);
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m_i[h], rmax);
      // a row whose max did not move gets corr = 2^0 = 1 exactly
      corr[h] = exp2_sfu(__fmul_rn(__fsub_rn(m_i[h], m_new), LOG2E));
      const float ml = __fmul_rn(m_new, LOG2E);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float& x = s[4 * (j >> 1) + 2 * h + (j & 1)];
        x = exp2_sfu(__fmaf_rn(x, LOG2E, -ml));  // 2^-inf == 0: dead elements
        t[j] = x;
      }
      float psum = wg::tree<false>(t);
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[h] = l_i[h] * corr[h] + psum;
      m_i[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] *= corr[i / 2];
    // P = P_hi + P_lo in TF32, the A fragments of k-step kk straight from the
    // S accumulators of its 8 columns (k = t4 is column 2·t4, k = t4 + 4 is
    // 2·t4 + 1: Vᵀ's keys lie in that order)
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sea::split_a(make_float2(s[4 * kk], s[4 * kk + 1]), make_float2(s[4 * kk + 2], s[4 * kk + 3]),
                   ph[kk], pl[kk]);

    // acc += P·V, three wgmmas a k-step, then the stage's Vᵀ is released
    sea::mbar_wait(vfull + 8 * st, par);
    sea::fence_regs(acc);
    sea::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t vhi = VT::kdesc(vs, kk), vlo = VT::kdesc(vs + VT::TILE, kk);
      sea::wgmma_tf32_rs<D>(acc, pl[kk], vhi);
      sea::wgmma_tf32_rs<D>(acc, ph[kk], vlo);
      sea::wgmma_tf32_rs<D>(acc, ph[kk], vhi);
    }
    sea::wgmma_commit();
    sea::wgmma_wait<0>();
    sea::fence_regs(acc);
    sea::fence_frags(ph);
    sea::fence_frags(pl);
    __syncwarp();
    if (lane == 0) sea::mbar_arrive(vempty + 8 * st);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long row = (long)bh * t_dst + lrow0 + 16 * warp + g + 8 * h;
    const float l = l_i[h];
    const float safe_l = l > 0.f ? l : 1.f;
    const float sc = scaler ? scaler[row] : 1.f;
    float* o = out + row * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(acc[4 * j + 2 * h] / safe_l * sc, acc[4 * j + 2 * h + 1] / safe_l * sc);
    // logsumexp; +inf for rows with no alive column, so that the backward's
    // exp(s - lse) is 0 there (m and l are equal across the lane quad)
    if (STATS && t4 == 0)
      lse[row] = l > 0.f ? m_i[h] + logf(l) : __uint_as_float(0x7f800000u);
  }
}

// ---------------------------------------------------------------------------
// K5's float32 instance on mma.sync
// ---------------------------------------------------------------------------
//
// The padded bidirectional forward in float32 (K5, BERT's path) keeps the
// body that served every float32 instance before `causal_tf32_wgmma_kernel`:
// FlashAttention-2's on mma.sync m16n8k8 in split TF32 (`mma_3xtf32`), one
// block of 4 warps per (batch·head, 64-row q-tile), K/V double-buffered by
// cp.async, the predicate per element (the pixel from the row's reciprocal,
// `sea::quot`, a word read, a shift and a select). At BERT's 32 x 12 x 256 it
// ran in 0.108 ms of device time where the wgmma body took 0.117
// (kernel_ab.py --parent, PERF.md §6): short rows give every block
// few sub-tiles, so the wgmma body's per-block setup (Q's split, the TMA
// round trips) is not paid back, while two of these blocks fit an SM.
namespace flat {

constexpr int BQ = sea::TILE;   // query rows per block
constexpr int BKT = sea::TILE;  // key columns per sub-tile
constexpr int TPB = 128;        // 4 warps, each owning 16 query rows
constexpr int NT = BKT / 8;     // 8-column score tiles of a sub-tile

// Two stages of (K, V) sub-tiles, then the q-tile, then its mask words. K
// and Q rows padded by 8 floats (float2 reads of rows g = 0..3 at banks 8·g
// + 2·t), V rows by 4 (reads of rows 2·t at banks 8·t + g): every fragment
// read is free of bank conflicts.
template <int D>
struct Smem {
  static constexpr int KLD = D + 8;
  static constexpr int VLD = D + 4;
  static constexpr int K_BYTES = BKT * KLD * 4;
  static constexpr int STAGE = K_BYTES + BKT * VLD * 4;
  static constexpr int Q_BYTES = BQ * KLD * 4;
  static constexpr int bytes = 2 * STAGE + Q_BYTES + BQ * MAX_WORDS * 4;
};

// One 64-column K/V sub-tile into a stage.
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* stage, const float* __restrict__ k,
                                        const float* __restrict__ v, long base, int tid) {
  using S = Smem<D>;
  sea::copy_rows<D, TPB>(reinterpret_cast<float*>(stage), S::KLD, k + base, tid);
  sea::copy_rows<D, TPB>(reinterpret_cast<float*>(stage + S::K_BYTES), S::VLD, v + base, tid);
}

}  // namespace flat

// The template arguments name the instance as the forward bodies' do; this
// body has K5's alone.
template <int D, bool STATS, bool BIDIR, int IMPL = FLAT>
__global__ void __launch_bounds__(flat::TPB, 2) causal_flat_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint32_t* __restrict__ mbits, const float* __restrict__ scaler,
    const int* __restrict__ counts, const int* __restrict__ idx,
    const int* __restrict__ lengths, float* __restrict__ out, int t_dst, int t_src, int t_m,
    int n_words, int block_q, int block_k, int nq, int nkb) {
  static_assert((D == 32 || D == 64) && !STATS && BIDIR && IMPL == FLAT,
                "K5's float32 instances");
  using S = flat::Smem<D>;
  using flat::BKT;
  using flat::BQ;
  using flat::NT;
  using flat::TPB;
  extern __shared__ __align__(16) unsigned char smem[];
  const float* Qs = reinterpret_cast<const float*>(smem + 2 * S::STAGE);
  uint32_t* Ms = reinterpret_cast<uint32_t*>(smem + 2 * S::STAGE + S::Q_BYTES);

  // blocks start in order of x, then y: every head's last q-tile first
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // first row of the tile
  const int qb = row0 / block_q;                       // q-block of the tile lists
  const int len = lengths[bh];
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the fragment row and column pair
  const int wrow0 = (tid >> 5) * 16;       // the warp's first row in the tile

  const long moff = ((long)bh * t_dst + row0) * n_words;
  for (int i = tid; i < BQ * n_words; i += TPB) Ms[i] = mbits[moff + i];
  // the q-tile goes to shared memory with the first K/V sub-tile
  const long qoff = ((long)bh * t_dst + row0) * D;
  sea::copy_rows<D, TPB>(reinterpret_cast<float*>(smem + 2 * S::STAGE), S::KLD, q + qoff, tid);

  // every row's width is the example's length, yw its reciprocal
  const float wf = (float)len, yw = sea::recip(wf);
  float m_i[2] = {M_INIT, M_INIT}, l_i[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const float dead = __uint_as_float(0xff800000u);  // -inf

  const int cnt = counts[bh * nq + qb];
  const int* lst = idx + ((long)bh * nq + qb) * nkb;
  const long kvbase = (long)bh * t_src * D;
  // The walk: advance (e, c0) to the first listed sub-tile at or after it
  // (list entry e, first column c0); false when the list is done. Columns
  // from the length on are dead on every row.
  auto seek = [&](int& e, int& c0) -> bool {
    for (; e < cnt; ++e, c0 = -1) {
      const int start = lst[e] * block_k;
      c0 = c0 < start ? start : c0;
      if (c0 < start + block_k && c0 < len && c0 < t_src) return true;
    }
    return false;
  };

  int e = 0, c0 = -1, stage = 0;
  bool have = seek(e, c0);
  if (have) flat::load_kv<D>(smem, k, v, kvbase + (long)c0 * D, tid);
  sea::cp_async_commit();
  while (have) {
    int ne = e, nc0 = c0 + BKT;
    const bool more = seek(ne, nc0);
    // the next sub-tile's copies run while this one's products do
    if (more) flat::load_kv<D>(smem + (stage ^ 1) * S::STAGE, k, v, kvbase + (long)nc0 * D, tid);
    sea::cp_async_commit();
    sea::cp_async_wait<1>();
    __syncthreads();  // this stage (and, first time, the mask words) landed
    const float* Ks = reinterpret_cast<const float*>(smem + stage * S::STAGE);
    const float* Vs = reinterpret_cast<const float*>(smem + stage * S::STAGE + S::K_BYTES);

    // S = Q·Kᵀ: s[j] is the C fragment of score columns 8·j .. 8·j + 7
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      // k = t4 is column 8·kk + 2·t4 of Q and K, k = t4 + 4 the one after
      uint32_t ah[4], al[4];
      sea::split_a(
          *reinterpret_cast<const float2*>(Qs + (wrow0 + g) * S::KLD + 8 * kk + 2 * t4),
          *reinterpret_cast<const float2*>(Qs + (wrow0 + g + 8) * S::KLD + 8 * kk + 2 * t4), ah,
          al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 kv =
            *reinterpret_cast<const float2*>(Ks + (8 * j + g) * S::KLD + 8 * kk + 2 * t4);
        sea::mma_3xtf32(s[j], ah, al, kv.x, kv.y);
      }
    }

    // the element predicate and the online softmax, row by row: element j's
    // column is c0 + 8·(j / 2) + 2·t4 + j % 2, its pixel from the row's
    // reciprocal (x0 + j's offset is the exact (float)col + 0.5)
    const float x0 = __fadd_rn((float)(c0 + 2 * t4), 0.5f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* words = Ms + (wrow0 + g + 8 * h) * n_words;
      float rmax = M_INIT;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        const int col = c0 + 8 * (j >> 1) + 2 * t4 + (j & 1);
        const float x = __fadd_rn(x0, (float)(8 * (j >> 1) + (j & 1)));
        const int pix = sea::len_clip(sea::floor_pixel(sea::quot(x, wf, yw), t_m), t_m);
        const bool a = (col < len) & sea::pixel_bit(words[pix >> 5], pix);
        float& xs = s[j >> 1][2 * h + (j & 1)];
        xs = a ? xs : dead;
        rmax = fmaxf(rmax, xs);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m_i[h], rmax);
      // exp(x - m) as 2^(x·log2 e - m·log2 e): one FFMA and the SFU's exp2;
      // a row whose max did not move gets corr = 2^0 = 1 exactly
      const float corr = exp2_sfu(__fmul_rn(__fsub_rn(m_i[h], m_new), LOG2E));
      const float ml = __fmul_rn(m_new, LOG2E);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        float& xs = s[j >> 1][2 * h + (j & 1)];
        xs = exp2_sfu(__fmaf_rn(xs, LOG2E, -ml));  // dead elements: 2^-inf == 0
        psum += xs;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[h] = l_i[h] * corr + psum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
      m_i[h] = m_new;
    }

    // acc += P·V, P from the S fragments (k = the sub-tile's columns; k =
    // t4 is column 8·kk + 2·t4, k = t4 + 4 the one after)
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[4], al[4];
      sea::split_a(make_float2(s[kk][0], s[kk][1]), make_float2(s[kk][2], s[kk][3]), ah, al);
      const float* v0 = Vs + (8 * kk + 2 * t4) * S::VLD + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        sea::mma_3xtf32(acc[j], ah, al, v0[8 * j], v0[S::VLD + 8 * j]);
    }
    __syncthreads();  // every warp is done with this stage before it refills
    e = ne;
    c0 = nc0;
    have = more;
    stage ^= 1;
  }
  sea::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = wrow0 + g + 8 * h;
    const float l = l_i[h];
    const float safe_l = l > 0.f ? l : 1.f;
    const float sc = scaler[(long)bh * t_dst + row0 + rl];
    float* o = out + qoff + (long)rl * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(acc[j][2 * h] / safe_l * sc, acc[j][2 * h + 1] / safe_l * sc);
  }
}

// The element masks of the debug entry points, from the bf16 body's own
// construction (`sea::alive_bits`): a block of 256 threads per (row,
// 64 sub-tiles), a quad of lanes per 64-column sub-tile, each lane writing
// its quarter of the columns. BIDIR: the predicate of K5, with the width
// lengths[bh]; else that of K1.
template <bool BIDIR>
__global__ void alive_mask_kernel(const uint32_t* __restrict__ mbits,
                                  const int* __restrict__ lengths,
                                  int8_t* __restrict__ out, int t_dst,
                                  int t_src, int t_m, int n_words) {
  const int bh = blockIdx.z, r = blockIdx.y, t4 = threadIdx.x & 3;
  const int c0 = 64 * (64 * blockIdx.x + (threadIdx.x >> 2));
  const int len = BIDIR ? lengths[bh] : 0;
  const float w = BIDIR ? (float)len : (float)(r + 1);
  const sea::AliveRow row[1] = {{mbits + ((long)bh * t_dst + r) * n_words, BIDIR ? len - 1 : r, w,
                                 sea::recip(w), __fdiv_rn((float)t_m, w),
                                 __fdiv_rn(w, (float)t_m)}};
  uint64_t bits[1];
  sea::alive_bits<BIDIR, true>(row, c0, t_m, 0, n_words - 1, t4, bits);
  int8_t* o = out + ((long)bh * t_dst + r) * t_src;
  for (int j = t4; j < 64 && c0 + j < t_src; j += 4) o[c0 + j] = (int8_t)((bits[0] >> j) & 1u);
}

// The restricted predicate of K9a-c alone, from the same construction with
// the impl's restriction, for a bit-for-bit check against the oracle.
// `tiles` (batch·head, nq, nkb) is dense over every (q-block, k-block): the
// listed tiles' word ranges, -1 where a tile is not listed (WORD_RANGE,
// WORD_LOOP), or their piece bitmasks, 0 where not listed (SUBTILE). Rows
// are global (no row base).
template <int IMPL>
__global__ void impl_alive_mask_kernel(const uint32_t* __restrict__ mbits,
                                       const int* __restrict__ tiles,
                                       int8_t* __restrict__ out, int t_dst,
                                       int t_src, int t_m, int n_words,
                                       int block_q, int block_k, int nq,
                                       int nkb, int sub) {
  const int bh = blockIdx.z, r = blockIdx.y, t4 = threadIdx.x & 3;
  const int c0 = 64 * (64 * blockIdx.x + (threadIdx.x >> 2));
  bool live = c0 < t_src;
  int wlo = 0, whi = n_words - 1;
  if (live) {
    const int kb = c0 / block_k;
    const int aux = tiles[((long)bh * nq + r / block_q) * nkb + kb];
    if (IMPL == SUBTILE) {
      live = (((unsigned)aux >> ((c0 - kb * block_k) / sub)) & 1u) != 0u;
    } else {
      live = aux >= 0;  // -1: not listed
      const sea::WordRange g = sea::word_range(aux);
      wlo = g.lo;
      whi = g.hi;
    }
  }
  const float w = (float)(r + 1);
  const sea::AliveRow row[1] = {{mbits + ((long)bh * t_dst + r) * n_words, live ? r : -1, w,
                                 sea::recip(w), __fdiv_rn((float)t_m, w),
                                 __fdiv_rn(w, (float)t_m)}};
  uint64_t bits[1];
  sea::alive_bits<false, IMPL == WORD_LOOP>(row, c0, t_m, wlo, whi, t4, bits);
  int8_t* o = out + ((long)bh * t_dst + r) * t_src;
  for (int j = t4; j < 64 && c0 + j < t_src; j += 4) o[c0 + j] = (int8_t)((bits[0] >> j) & 1u);
}

// The forward's quotient from a row's reciprocal (sea::quot) against IEEE
// division, for x = s + 0.5 and s + 1 on every 0 <= s < w <= w_max: the
// number of quotients whose bits differ is added to *bad.
__global__ void quot_check_kernel(int w_max, unsigned long long* bad) {
  unsigned long long n = 0;
  for (int w = blockIdx.x + 1; w <= w_max; w += gridDim.x) {
    const float wf = (float)w, y = sea::recip(wf);
    for (int s = threadIdx.x; s < w; s += blockDim.x) {
      const float xs[2] = {__fadd_rn((float)s, 0.5f), (float)(s + 1)};
#pragma unroll
      for (int i = 0; i < 2; ++i)
        n += __float_as_uint(sea::quot(xs[i], wf, y)) != __float_as_uint(__fdiv_rn(xs[i], wf));
    }
  }
  if (n) atomicAdd(bad, n);
}

// The alive-word construction against the per-column pixel map: for every
// row width 1 <= w <= w_max, T_M = 128, 256 and 512, and two masks (every
// even pixel alive, every odd one, so that each run boundary flips a bit),
// the words `alive_bits` builds over every 64-column sub-tile of the causal
// row w − 1 and of a bidirectional row of length w, against each column's
// pixel by IEEE division (`causal_pixel`; the clipped form for the length).
// The number of columns whose bit differs is added to *bad. 256 threads a
// block, a quad a sub-tile.
__global__ void word_check_kernel(int w_max, unsigned long long* bad) {
  __shared__ uint32_t pattern[2][MAX_WORDS];
  if (threadIdx.x < 2 * MAX_WORDS)
    pattern[threadIdx.x / MAX_WORDS][threadIdx.x % MAX_WORDS] =
        threadIdx.x < MAX_WORDS ? 0x55555555u : 0xaaaaaaaau;
  __syncthreads();
  const int t4 = threadIdx.x & 3, quad = threadIdx.x >> 2;
  unsigned long long n = 0;
  for (int w = blockIdx.x + 1; w <= w_max; w += gridDim.x) {
    const float wf = (float)w, y = sea::recip(wf);
    for (int t_m = 128; t_m <= 512; t_m *= 2) {
      const float tm_w = __fdiv_rn((float)t_m, wf), w_tm = __fdiv_rn(wf, (float)t_m);
      for (int pat = 0; pat < 2; ++pat) {
        for (int c = 0; c < w; c += 64 * 64) {
          const int c0 = c + 64 * quad;
          const sea::AliveRow row[1] = {{pattern[pat], w - 1, wf, y, tm_w, w_tm}};
          uint64_t causal[1], bidir[1];
          sea::alive_bits<false, false>(row, c0, t_m, 0, MAX_WORDS - 1, t4, causal);
          sea::alive_bits<true, false>(row, c0, t_m, 0, MAX_WORDS - 1, t4, bidir);
          for (int j = t4; j < 64 && c0 + j < w; j += 4) {
            const int s = c0 + j;
            const int pc = sea::causal_pixel(s, w - 1, t_m);
            const int pb = sea::len_clip(
                sea::floor_pixel(__fdiv_rn(__fadd_rn((float)s, 0.5f), wf), t_m), t_m);
            n += ((causal[0] >> j) & 1u) != (uint64_t)(pc >= 0 && (pc & 1) == pat);
            n += ((bidir[0] >> j) & 1u) != (uint64_t)((pb & 1) == pat);
          }
        }
      }
    }
  }
  if (n) atomicAdd(bad, n);
}

// One launch of the body: the float32 instances on wgmma in split TF32
// (`causal_tf32_wgmma_kernel`; t_dst a multiple of the block's 64 or 128
// rows) but K5's on mma.sync (`causal_flat_kernel`), the bf16 ones on wgmma
// (128-row tiles).
template <int D, typename T, bool STATS, bool BIDIR, int IMPL = FLAT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mbits, const void* scaler, const void* counts,
                   const void* idx, const void* tiles, const void* rowbase,
                   const void* lengths, void* out, void* lse, int nh,
                   int t_dst, int t_src, int t_m, int n_words, int block_q,
                   int block_k, int nq, int nkb, int sub, float oversample,
                   float k_cfg, float keep_lo, float keep_hi, int col_base,
                   cudaStream_t stream) {
  if (misaligned(q, k, v, out)) return cudaErrorInvalidValue;
  constexpr int LIST = IMPL == FLAT ? 1 : 2;
  CUtensorMap tq, tk, tv;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  cudaError_t e;
  if constexpr (std::is_same<T, float>::value && BIDIR) {
    constexpr int bytes = flat::Smem<D>::bytes;
    e = sea::opt_in_smem(causal_flat_kernel<D, STATS, BIDIR, IMPL>, bytes, opted_in);
    if (e != cudaSuccess) return e;
    causal_flat_kernel<D, STATS, BIDIR, IMPL><<<dim3(nh, t_dst / flat::BQ), flat::TPB, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const uint32_t*)mbits,
        (const float*)scaler, (const int*)counts, (const int*)idx, (const int*)lengths,
        (float*)out, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb);
  } else if constexpr (std::is_same<T, float>::value) {
    using C = tf::Config<D>;
    using QT = typename tf::Layout<D>::QT;
    const int bytes = tf::Layout<D>::FIXED + C::CONSUMERS * nkb * 4 * LIST;
    if (t_dst % C::BQ != 0 || bytes > wg::SMEM_MAX) return cudaErrorInvalidValue;
    e = sea::f32_map<QT::PW>(&tq, q, (long)nh * t_dst, D);
    if (e == cudaSuccess) e = sea::f32_map<QT::PW>(&tk, k, (long)nh * t_src, D);
    if (e == cudaSuccess) e = sea::f32_map<QT::PW>(&tv, v, (long)nh * t_src, D);
    if (e == cudaSuccess)
      e = sea::opt_in_smem(causal_tf32_wgmma_kernel<D, STATS, BIDIR, IMPL>, wg::SMEM_MAX,
                           opted_in);
    if (e != cudaSuccess) return e;
    causal_tf32_wgmma_kernel<D, STATS, BIDIR, IMPL>
        <<<dim3(nh, t_dst / C::BQ), C::THREADS, bytes, stream>>>(
            tq, tk, tv, (const uint32_t*)mbits, (const float*)scaler, (const int*)counts,
            (const int*)idx, (const int*)tiles, (const int*)rowbase, (const int*)lengths,
            (float*)out, (float*)lse, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb,
            sub, oversample, k_cfg, keep_lo, keep_hi, col_base);
  } else {
    const int bytes = wg::Layout<D>::FIXED + wg::CONSUMERS * nkb * 4 * LIST;
    if (t_dst % wg::BQ != 0 || bytes > wg::SMEM_MAX) return cudaErrorInvalidValue;
    e = sea::tile_map<D>(&tq, q, (long)nh * t_dst);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tk, k, (long)nh * t_src);
    if (e == cudaSuccess) e = sea::tile_map<D>(&tv, v, (long)nh * t_src);
    if (e == cudaSuccess)
      e = sea::opt_in_smem(causal_wgmma_kernel<D, STATS, BIDIR, IMPL>, wg::SMEM_MAX, opted_in);
    if (e != cudaSuccess) return e;
    dim3 grid(nh, t_dst / wg::BQ);
    causal_wgmma_kernel<D, STATS, BIDIR, IMPL><<<grid, wg::THREADS, bytes, stream>>>(
        tq, tk, tv, (const uint32_t*)mbits, (const float*)scaler, (const int*)counts,
        (const int*)idx, (const int*)tiles, (const int*)rowbase, (const int*)lengths,
        (__nv_bfloat16*)out, (float*)lse, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb,
        sub, oversample, k_cfg, keep_lo, keep_hi, col_base);
  }
  return cudaGetLastError();
}

// What the impl entry points take besides the common geometry: SUBTILE's
// pieces are whole 64-column sub-tiles, tile an outer k-block and number at
// most 32 (one int32 bitmask).
inline bool bad_pieces(int impl, int block_k, int sub) {
  return impl == SUBTILE &&
         (sub <= 0 || sub % sea::TILE != 0 || block_k % sub != 0 || block_k / sub > 32);
}

// K9a-c: the causal forward with the impl's restricted predicate; f32 or bf16.
template <int IMPL>
int impl_forward(const void* q, const void* k, const void* v,
                 const void* mbits, const void* scaler, const void* counts,
                 const void* idx, const void* tiles, const void* rowbase,
                 void* out, int nh, int t_dst, int t_src, int head_dim,
                 int t_m, int n_words, int block_q, int block_k, int nq,
                 int nkb, int sub, float oversample, float k_cfg,
                 float keep_lo, float keep_hi, int is_bf16, void* stream) {
  if (bad_geometry(sea::BASE_WIDTHS{}, head_dim, n_words, t_dst, t_src, block_q, block_k) ||
      bad_pieces(IMPL, block_k, sub))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      is_bf16 ? launch<64, __nv_bfloat16, false, false, IMPL>(
                    q, k, v, mbits, scaler, counts, idx, tiles, rowbase,
                    nullptr, out, nullptr, nh, t_dst, t_src, t_m, n_words,
                    block_q, block_k, nq, nkb, sub, oversample, k_cfg, keep_lo,
                    keep_hi, 0, s)
              : launch<64, float, false, false, IMPL>(
                    q, k, v, mbits, scaler, counts, idx, tiles, rowbase,
                    nullptr, out, nullptr, nh, t_dst, t_src, t_m, n_words,
                    block_q, block_k, nq, nkb, sub, oversample, k_cfg, keep_lo,
                    keep_hi, 0, s);
  return (int)e;
}

}  // namespace

extern "C" int sea_causal_flat_forward(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* rowbase, void* out, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, float oversample, float k_cfg, float keep_lo, float keep_hi,
    int is_bf16, void* stream) {
  if (bad_geometry(sea::FORWARD_WIDTHS{}, head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(sea::FORWARD_WIDTHS{}, head_dim, is_bf16, [&](auto d, auto t) {
    return launch<decltype(d)::value, typename decltype(t)::type, false, false>(
        q, k, v, mbits, scaler, counts, idx, nullptr, rowbase, nullptr, out, nullptr, nh,
        t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, 0, oversample, k_cfg,
        keep_lo, keep_hi, 0, (cudaStream_t)stream);
  });
}

// The forward of the differentiable path (K2): f32 or bf16 in and out, lse
// (nh, t_dst) float32; head width 64, 80 or 128.
extern "C" int sea_causal_fwd_stats(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* rowbase, void* out, void* lse, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, int is_bf16, void* stream) {
  if (bad_geometry(sea::TRAIN_WIDTHS{}, head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(sea::TRAIN_WIDTHS{}, head_dim, is_bf16, [&](auto d, auto t) {
    return launch<decltype(d)::value, typename decltype(t)::type, true, false>(
        q, k, v, mbits, scaler, counts, idx, nullptr, rowbase, nullptr, out, lse, nh, t_dst,
        t_src, t_m, n_words, block_q, block_k, nq, nkb, 0, 1.0f, 1.0f, 1.0f, 1.0f, 0,
        (cudaStream_t)stream);
  });
}

// K6, the forward with stats over one K/V window (K2's instance, float32 or
// bf16, head width 64): k and v are (nh, t_win, D) and hold the global
// columns col_base .. col_base + t_win − 1; idx (nh, nq, nkw) carries global
// k-block ids of that window; the scaler is one; out (nh, t_dst, D), in q's
// type, is the window-normalised output and lse (nh, t_dst) float32 the
// window's logsumexp, +inf on rows with nothing alive in it.
extern "C" int sea_window_fwd_stats(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* counts, const void* idx, const void* rowbase, void* out,
    void* lse, int nh, int t_dst, int t_win, int head_dim, int t_m,
    int n_words, int block_q, int block_k, int nq, int nkw, int col_base,
    int is_bf16, void* stream) {
  if (bad_geometry(sea::BASE_WIDTHS{}, head_dim, n_words, t_dst, t_win, block_q, block_k) ||
      bad_window(col_base, block_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<64, __nv_bfloat16, true, false>(
                             q, k, v, mbits, nullptr, counts, idx, nullptr, rowbase, nullptr,
                             out, lse, nh, t_dst, t_win, t_m, n_words, block_q, block_k, nq,
                             nkw, 0, 1.0f, 1.0f, 1.0f, 1.0f, col_base, s)
                       : launch<64, float, true, false>(
                             q, k, v, mbits, nullptr, counts, idx, nullptr, rowbase, nullptr,
                             out, lse, nh, t_dst, t_win, t_m, n_words, block_q, block_k, nq,
                             nkw, 0, 1.0f, 1.0f, 1.0f, 1.0f, col_base, s));
}

// The padded bidirectional forward (K5): f32 or bf16 in and out, `lengths`
// (nh,) int32, the row width of each batch·head; head width 32 or 64.
extern "C" int sea_bidir_forward(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* lengths, void* out, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, int is_bf16, void* stream) {
  if (bad_geometry(sea::BIDIR_WIDTHS{}, head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(sea::BIDIR_WIDTHS{}, head_dim, is_bf16, [&](auto d, auto t) {
    return launch<decltype(d)::value, typename decltype(t)::type, false, true>(
        q, k, v, mbits, scaler, counts, idx, nullptr, nullptr, lengths, out, nullptr, nh,
        t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, 0, 1.0f, 1.0f, 1.0f, 1.0f, 0,
        (cudaStream_t)stream);
  });
}

extern "C" int sea_alive_mask(const void* mbits, void* out, int nh, int t_dst,
                              int t_src, int t_m, int n_words, void* stream) {
  dim3 grid((t_src + 4095) / 4096, t_dst, nh);
  alive_mask_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mbits, nullptr, (int8_t*)out, t_dst, t_src, t_m,
      n_words);
  return (int)cudaGetLastError();
}

extern "C" int sea_bidir_alive_mask(const void* mbits, const void* lengths,
                                    void* out, int nh, int t_dst, int t_src,
                                    int t_m, int n_words, void* stream) {
  dim3 grid((t_src + 4095) / 4096, t_dst, nh);
  alive_mask_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mbits, (const int*)lengths, (int8_t*)out, t_dst, t_src,
      t_m, n_words);
  return (int)cudaGetLastError();
}

// K9a, impl "flat_wr" (`_causal_kernel_flat_wr`): `wr` (nh, nq, nkb) int32
// beside idx, each listed tile's word range lo | hi << 8 | exact << 16.
extern "C" int sea_causal_word_range_forward(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx, const void* wr,
    const void* rowbase, void* out, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, int sub, float oversample, float k_cfg, float keep_lo,
    float keep_hi, int is_bf16, void* stream) {
  return impl_forward<WORD_RANGE>(q, k, v, mbits, scaler, counts, idx, wr,
                                  rowbase, out, nh, t_dst, t_src, head_dim,
                                  t_m, n_words, block_q, block_k, nq, nkb, sub,
                                  oversample, k_cfg, keep_lo, keep_hi, is_bf16,
                                  stream);
}

// K9b, impl "flat_fori" (`_causal_kernel_flat_fori`): the same operands.
extern "C" int sea_causal_word_loop_forward(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx, const void* wr,
    const void* rowbase, void* out, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, int sub, float oversample, float k_cfg, float keep_lo,
    float keep_hi, int is_bf16, void* stream) {
  return impl_forward<WORD_LOOP>(q, k, v, mbits, scaler, counts, idx, wr,
                                 rowbase, out, nh, t_dst, t_src, head_dim, t_m,
                                 n_words, block_q, block_k, nq, nkb, sub,
                                 oversample, k_cfg, keep_lo, keep_hi, is_bf16,
                                 stream);
}

// K9c, impl "subtile" (`_causal_kernel`): idx lists outer k-blocks of
// block_k columns and `submask` (nh, nq, nkb) int32 their active `sub`-wide
// pieces, bit p for columns p·sub .. (p + 1)·sub − 1 of the block.
extern "C" int sea_causal_subtile_forward(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* submask, const void* rowbase, void* out, int nh, int t_dst,
    int t_src, int head_dim, int t_m, int n_words, int block_q, int block_k,
    int nq, int nkb, int sub, float oversample, float k_cfg, float keep_lo,
    float keep_hi, int is_bf16, void* stream) {
  return impl_forward<SUBTILE>(q, k, v, mbits, scaler, counts, idx, submask,
                               rowbase, out, nh, t_dst, t_src, head_dim, t_m,
                               n_words, block_q, block_k, nq, nkb, sub,
                               oversample, k_cfg, keep_lo, keep_hi, is_bf16,
                               stream);
}

// The restricted predicate of impl 1 (K9a), 2 (K9b) or 3 (K9c) over the dense
// `tiles` table (see impl_alive_mask_kernel).
extern "C" int sea_impl_alive_mask(const void* mbits, const void* tiles,
                                   void* out, int impl, int nh, int t_dst,
                                   int t_src, int t_m, int n_words,
                                   int block_q, int block_k, int sub,
                                   void* stream) {
  if (n_words > MAX_WORDS || block_q <= 0 || block_k <= 0 || t_dst % block_q ||
      t_src % block_k || (impl == SUBTILE && bad_pieces(impl, block_k, sub)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((t_src + 4095) / 4096, t_dst, nh);
  const int nq = t_dst / block_q, nkb = t_src / block_k;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* m = (const uint32_t*)mbits;
  const int* tl = (const int*)tiles;
  int8_t* o = (int8_t*)out;
  switch (impl) {
    case WORD_RANGE:
      impl_alive_mask_kernel<WORD_RANGE><<<grid, 256, 0, s>>>(
          m, tl, o, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, sub);
      break;
    case WORD_LOOP:
      impl_alive_mask_kernel<WORD_LOOP><<<grid, 256, 0, s>>>(
          m, tl, o, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, sub);
      break;
    case SUBTILE:
      impl_alive_mask_kernel<SUBTILE><<<grid, 256, 0, s>>>(
          m, tl, o, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, sub);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// quot_check_kernel and word_check_kernel over 1 <= w <= w_max; `bad` two
// uint64 on the device, zeroed by the caller: the quotients' mismatches,
// then the alive words'.
extern "C" int sea_quot_check(int w_max, void* bad, void* stream) {
  if (w_max <= 0 || w_max > (1 << 24)) return (int)cudaErrorInvalidValue;
  unsigned long long* counts = (unsigned long long*)bad;
  quot_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(w_max, counts);
  word_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(w_max, counts + 1);
  return (int)cudaGetLastError();
}
