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
// Two bodies each, one per element type. Both walk the same lists in the
// same order and read the same element mask; a sub-tile with no alive
// element adds exact zeros (P = dS = 0), so lists of other block sizes, or a
// shard that never lists it, give the same bits. Deterministic: no atomics,
// no row (dq) or column (dk/dv) split across blocks, every sum in a fixed
// order; two launches are equal bit for bit. exp is 2^x on the SFU.
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
//     the float32 bodies' predicate.
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
// The float32 bodies (`causal_dq_kernel`, `causal_dkv_kernel`) are
// FlashAttention-2's backward on mma.sync in split TF32 ("3xTF32", as the
// forward's float32 body: each operand hi + lo in TF32, a·b summed as
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with m16n8k8 TF32 mmas into float32,
// each product to about 2^-21 of its size). wgmma takes TF32 operands only
// K-major, and dS·K, Pᵀ·dO and dSᵀ·Q read their B operand MN-major, so they
// would need transposed copies of K, Q and dO: a later redesign. A block is
// 4 warps (128 threads); every product is one of the forward's two shapes
// (sea_mma.cuh): Q·Kᵀ-shaped, with both operands read as float2 along d, or
// P·V-shaped, with the A operand a C fragment as it stands and B read down
// its columns.
//   * dq: one block per (batch·head, 64-row q-tile), every head's last
//     (heaviest causal) q-tile first; each warp owns 16 rows, and each
//     thread keeps its two rows' lse·log2 e, delta, width and reciprocal in
//     registers. Q, dO and the rows' mask words stay in shared memory; the
//     block walks the q-block's list (`counts`/`idx`) in 64-column
//     sub-tiles, in increasing order, stopping at the causal edge and the
//     window's end, with the K and V sub-tiles double-buffered by cp.async.
//     Per sub-tile: S = Q·Kᵀ and dP = dO·Vᵀ, the element predicate in the
//     fragment layout, P = 2^(S·log2 e − lse·log2 e) where alive and exactly
//     0 elsewhere, dS = P·(dP − delta) in place of S, and dq += dS·K.
//   * dk/dv: one block per (batch·head, 64-column k-tile), every head's
//     first (heaviest causal) k-tile first; each warp owns 16 k-columns, and
//     K and V stay in shared memory. The block walks the TRANSPOSED lists
//     (`counts_t`/`idx_t`) in 64-row q sub-tiles, in increasing order,
//     skipping sub-tiles whose rows all end before the k-tile; each
//     sub-tile's Q, dO and mask words arrive by cp.async and its 64 rows'
//     lse·log2 e, delta, width and reciprocal are computed once, all double-
//     buffered. Per sub-tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, the predicate (a
//     thread's 16 fragment columns are 16 query rows, whose terms come from
//     shared memory), Pᵀ, dSᵀ = Pᵀ·(dPᵀ − delta) in place of dPᵀ, then
//     dv += Pᵀ·dO and dk += dSᵀ·Q.
//   * Shared tiles have rows padded by 8 floats, as the forward pads K and
//     Q: float2 reads along rows are free of bank conflicts, and the scalar
//     reads down columns (K in dq, Q and dO in dk/dv) meet two-way conflicts
//     but take immediate offsets. dq takes 112 KB (two blocks an SM), dk/dv
//     118 KB (one), at width 64; at 80 dq takes 136 KB (one) and dk/dv 142
//     KB; at 128 dq 208 KiB (6 tiles of 34816 bytes and 4 KiB of mask words)
//     and dk/dv 214 KiB (K and V, then two stages of Q, dO, the words and
//     the row terms), one block an SM each, under the 227 KiB opt-in. At 80
//     the row reads stay conflict-free (rows g = 0..3 of a half-warp on banks
//     24·g + 2·t mod 32) and the column reads two-way, as at 64; at 128 the
//     strides (136 floats) have width 64's residues mod 32.
//   * Width 128: the accumulators outgrow the registers (dq's is 64 floats
//     a thread, dk's and dv's 128 together), so dq walks each 64-column
//     sub-tile in two parts of 32 columns (`DQ_PARTS`), and dk/dv runs 8
//     warps (`DKV_SPLIT`): warps w and w + 4 own the same 16 k-columns, each
//     summing half of D's columns of dk and dv, and both compute the whole
//     Sᵀ and dPᵀ of those columns. Neither moves a bit of a sum's order.
//   * The splits round by integer operations (`sea::to_tf32_rna`: cvt.rna's
//     bits without its NaN and infinity checks).
//   * The predicate is per element: the pixel quotient from each row's
//     reciprocal (`sea::causal_pixel_recip`, IEEE division's bits), a word
//     read, a shift and a select.
//
// Head widths: K3 and K4 are built at D = 64, 80 (OPT-2.7b) and 128
// (LLaMA-7b and 13b) in both types and pick the instance by head_dim at
// launch (`sea::dispatch` over sea::TRAIN_WIDTHS); K7 and K8 take 64 only
// (sea::BASE_WIDTHS).

#include <type_traits>

#include "sea_mask.cuh"
#include "sea_mma.cuh"

namespace {

using sea::alive_elem_recip;
using sea::bad_geometry;
using sea::bad_window;
using sea::copy_rows;
using sea::cp_async4;
using sea::cp_async_commit;
using sea::cp_async_wait;
using sea::exp2_sfu;
using sea::LOG2E;
using sea::MAX_DEVICES;
using sea::MAX_WORDS;
using sea::misaligned;
using sea::mma_3xtf32;
using sea::split_a;
using sea::split_bf16;

// ---------------------------------------------------------------------------
// The float32 bodies on mma.sync (split TF32)
// ---------------------------------------------------------------------------

constexpr int BQ = sea::TILE;   // query rows per tile
constexpr int BKT = sea::TILE;  // key columns per tile
constexpr int TPB = 128;        // 4 warps of 16 rows (dq) or 16 columns (dk/dv)
// dk/dv: the warps that share a k-tile's 16 columns, each summing D / split
// of dk's and dv's columns (two at width 128, see the header), and its block
template <int D>
constexpr int DKV_SPLIT = D > 80 ? 2 : 1;
template <int D>
constexpr int DKV_TPB = TPB * DKV_SPLIT<D>;
// dq: the parts a 64-column sub-tile is walked in
template <int D>
constexpr int DQ_PARTS = D > 80 ? 2 : 1;
template <int D>
constexpr int LD = D + 8;  // elements of a padded tile row
template <int D>
constexpr int TILE_F = 64 * LD<D>;  // elements of one tile
template <int D>
constexpr int TILE_BYTES = TILE_F<D> * 4;

// dq: two stages of (K, V), then Q, dO, then the mask words.
template <int D>
constexpr int DQ_SMEM = 6 * TILE_BYTES<D> + BQ * MAX_WORDS * 4;
// dk/dv: K, V, then two stages of (Q, dO, mask words, row terms).
template <int D>
constexpr int DKV_STAGE = 2 * TILE_BYTES<D> + BQ * MAX_WORDS * 4 + BQ * 16;
template <int D>
constexpr int DKV_SMEM = 2 * TILE_BYTES<D> + 2 * DKV_STAGE<D>;

template <int D>
__device__ __forceinline__ float2 ld2(const float* tile, int c, int d) {
  return *reinterpret_cast<const float2*>(tile + c * LD<D> + d);
}

// 64 rows of D elements into a tile by THREADS threads
template <int D, int THREADS = TPB>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src, int tid) {
  copy_rows<D, THREADS>(dst, LD<D>, src, tid);
}

template <int D>
__global__ void __launch_bounds__(TPB, 2) causal_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint32_t* __restrict__ mbits,
    const float* __restrict__ dou, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts,
    const int* __restrict__ idx, const int* __restrict__ rowbase,
    float* __restrict__ dq, int t_dst, int t_src, int t_m, int n_words,
    int block_q, int block_k, int nq, int nkb, int col_base) {
  static_assert(D % 16 == 0, "head width");
  constexpr int LDD = LD<D>, TF = TILE_F<D>;
  constexpr int NJ = BKT / 8 / DQ_PARTS<D>;  // fragment columns of a part
  extern __shared__ __align__(16) unsigned char smem[];
  float* const kv_st = reinterpret_cast<float*>(smem);  // stage s: K, then V
  float* const Qs = kv_st + 4 * TF;
  float* const Os = Qs + TF;
  uint32_t* const Ms = reinterpret_cast<uint32_t*>(smem + 6 * TILE_BYTES<D>);

  // blocks start in order of x, then y: every head's last q-tile first
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // first local row of the tile
  const int qb = row0 / block_q;
  const int grow0 = rowbase[qb] + (row0 - qb * block_q);
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow0 = (tid >> 5) * 16;

  const long moff = ((long)bh * t_dst + row0) * n_words;
  for (int i = tid; i < BQ * n_words; i += TPB) Ms[i] = mbits[moff + i];
  const long qoff = ((long)bh * t_dst + row0) * D;
  copy_tile<D>(Qs, q + qoff, tid);
  copy_tile<D>(Os, dou + qoff, tid);

  // per fragment row h (tile row wrow0 + g + 8·h): lse·log2 e, delta, the
  // causal width and its reciprocal
  float l2[2], dl[2], wf[2], yw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = wrow0 + g + 8 * h;
    l2[h] = __fmul_rn(lse[(long)bh * t_dst + row0 + rl], LOG2E);
    dl[h] = delta[(long)bh * t_dst + row0 + rl];
    wf[h] = (float)(grow0 + rl + 1);
    yw[h] = sea::recip(wf[h]);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int cnt = counts[bh * nq + qb];
  const int* lst = idx + ((long)bh * nq + qb) * nkb;
  const int col_end = grow0 + BQ;  // every column from here on is dead
  // k and v hold the (global) columns col_base .. col_stop − 1; col_stop and
  // every c0 are multiples of 64, so a visited sub-tile lies wholly inside
  const int col_stop = col_base + t_src;
  const long kvbase = ((long)bh * t_src - col_base) * D;

  // advance (e, c0) to the first visited sub-tile at or after it; false
  // when the list is done
  auto seek = [&](int& e, int& c0) -> bool {
    for (; e < cnt; ++e, c0 = -1) {
      const int start = lst[e] * block_k;
      c0 = c0 < start ? start : c0;
      // inside the block and not wholly past the causal edge or the window
      if (c0 < start + block_k && c0 < col_end && c0 < col_stop) return true;
    }
    return false;
  };
  auto load_kv = [&](int stage, int c0) {
    float* Kd = kv_st + stage * 2 * TF;
    copy_tile<D>(Kd, k + kvbase + (long)c0 * D, tid);
    copy_tile<D>(Kd + TF, v + kvbase + (long)c0 * D, tid);
  };

  int e = 0, c0 = -1, stage = 0;
  bool have = seek(e, c0);
  if (have) load_kv(0, c0);
  cp_async_commit();
  while (have) {
    int ne = e, nc0 = c0 + BKT;
    const bool more = seek(ne, nc0);
    // the next sub-tile's copies run while this one's products do
    if (more) load_kv(stage ^ 1, nc0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage (and, first time, Q, dO and the words) landed
    const float* Ks = kv_st + stage * 2 * TF;
    const float* Vs = Ks + TF;

    // The sub-tile's columns in DQ_PARTS parts of 8·NJ (one part at widths
    // 64 and 80, two at 128, where the score fragments of a whole sub-tile
    // beside dq's accumulator would spill): each part's dS is made and
    // summed into dq before the next part's, the columns in increasing
    // order, so the parts change no bit.
#pragma unroll 1
    for (int part = 0; part < DQ_PARTS<D>; ++part) {
      const int j0 = part * NJ;  // the part's first fragment column
      // S = Q·Kᵀ and dP = dO·Vᵀ: s[j], dp[j] the C fragments of score
      // columns 8·(j0 + j) .. 8·(j0 + j) + 7
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int d = 8 * kk + 2 * t4;
        uint32_t qh[4], ql[4], oh[4], ol[4];
        split_a(ld2<D>(Qs, wrow0 + g, d), ld2<D>(Qs, wrow0 + g + 8, d), qh, ql);
        split_a(ld2<D>(Os, wrow0 + g, d), ld2<D>(Os, wrow0 + g + 8, d), oh, ol);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kf = ld2<D>(Ks, 8 * (j0 + j) + g, d);
          const float2 vf = ld2<D>(Vs, 8 * (j0 + j) + g, d);
          mma_3xtf32(s[j], qh, ql, kf.x, kf.y);
          mma_3xtf32(dp[j], oh, ol, vf.x, vf.y);
        }
      }

      // the element predicate, P and dS, row by row: element (j, b) of row
      // h is column c0 + 8·(j0 + j) + 2·t4 + b
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wrow0 + g + 8 * h;
        const int r = grow0 + rl;
        const uint32_t* words = Ms + rl * n_words;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int col = c0 + 8 * (j0 + j) + 2 * t4 + b;
            const float x = __fadd_rn((float)col, 0.5f);
            float& sv = s[j][2 * h + b];
            // off the mask P is exactly 0 (an empty row's lse = +inf never
            // meets a score)
            const float p = alive_elem_recip(words, x, col, r, wf[h], yw[h], t_m)
                                ? exp2_sfu(__fmaf_rn(sv, LOG2E, -l2[h])) : 0.f;
            sv = p * (dp[j][2 * h + b] - dl[h]);
          }
      }

      // dq += dS·K, dS from the S fragments (k = the part's columns)
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        uint32_t ah[4], al[4];
        split_a(make_float2(s[kk][0], s[kk][1]), make_float2(s[kk][2], s[kk][3]), ah, al);
        const int c = 8 * (j0 + kk) + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          mma_3xtf32(acc[j], ah, al, Ks[c * LDD + 8 * j + g], Ks[(c + 1) * LDD + 8 * j + g]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
    e = ne;
    c0 = nc0;
    have = more;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = dq + qoff + (long)(wrow0 + g + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(DKV_TPB<D>, 1) causal_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint32_t* __restrict__ mbits,
    const float* __restrict__ dou, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts_t,
    const int* __restrict__ idx_t, const int* __restrict__ rowbase,
    float* __restrict__ dk, float* __restrict__ dv, int t_dst, int t_src,
    int t_m, int n_words, int block_q, int block_k, int nq, int nkb,
    int col_base) {
  static_assert(D % 16 == 0, "head width");
  constexpr int THREADS = DKV_TPB<D>;
  constexpr int DH = D / DKV_SPLIT<D>;  // the columns of dk and dv a warp sums
  constexpr int STAGE = DKV_STAGE<D>;
  constexpr int LDD = LD<D>, TF = TILE_F<D>, TB = TILE_BYTES<D>;
  constexpr int PARTS = D > 64 ? 2 : 1;  // see the sub-tile's loop
  constexpr int NJ = BQ / 8 / PARTS;      // fragment rows of a part
  static_assert(DH % 16 == 0, "split head width");
  extern __shared__ __align__(16) unsigned char smem[];
  float* const Ks = reinterpret_cast<float*>(smem);
  float* const Vs = Ks + TF;
  // stage s: Q, dO, the mask words, then per row (lse·log2 e, delta, the
  // causal width, its reciprocal)
  unsigned char* const q_st = smem + 2 * TB;
  auto Qs = [&](int s) { return reinterpret_cast<float*>(q_st + s * STAGE); };
  auto Ms = [&](int s) { return reinterpret_cast<uint32_t*>(q_st + s * STAGE + 2 * TB); };
  auto Rs = [&](int s) {
    return reinterpret_cast<float4*>(q_st + s * STAGE + 2 * TB + BQ * MAX_WORDS * 4);
  };

  // blocks start in order of x, then y: every head's first k-tile first
  const int bh = blockIdx.x;
  const int col0 = blockIdx.y * BKT;  // first column of the k-tile in k, v
  const int kb = col0 / block_k;      // k-block of the transposed lists
  const int gcol0 = col_base + col0;  // its global column
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // the warp's first column in the tile, and its first column of dk and dv
  // (0 without a split: the widths before 128 keep their address math)
  const int warp = tid >> 5;
  const int wcol0 = (DKV_SPLIT<D> > 1 ? warp % 4 : warp) * 16;
  const int d0 = DKV_SPLIT<D> > 1 ? (warp / 4) * DH : 0;

  const long koff = ((long)bh * t_src + col0) * D;
  copy_tile<D, THREADS>(Ks, k + koff, tid);
  copy_tile<D, THREADS>(Vs, v + koff, tid);

  // per fragment row h: the k-tile column wcol0 + g + 8·h, global, and its
  // exact (float)col + 0.5
  int gc[2];
  float xc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gc[h] = gcol0 + wcol0 + g + 8 * h;
    xc[h] = __fadd_rn((float)gc[h], 0.5f);
  }
  float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;

  const int cnt = counts_t[bh * nkb + kb];
  const int* lst = idx_t + ((long)bh * nkb + kb) * nq;
  const long rbase = (long)bh * t_dst;
  // the global row of the sub-tile at local row r0 of list entry e
  auto grow_of = [&](int e, int r0) { return rowbase[lst[e]] + (r0 - lst[e] * block_q); };

  // advance (e, r0) to the first visited sub-tile at or after it; false
  // when the list is done
  auto seek = [&](int& e, int& r0) -> bool {
    for (; e < cnt; ++e, r0 = -1) {
      const int start = lst[e] * block_q;
      for (r0 = r0 < start ? start : r0; r0 < start + block_q && r0 < t_dst; r0 += BQ)
        // skip a sub-tile whose every row ends before the k-tile
        if (grow_of(e, r0) + BQ - 1 >= gcol0) return true;
    }
    return false;
  };
  auto load_q = [&](int s, int r0) {
    copy_tile<D, THREADS>(Qs(s), q + (rbase + r0) * D, tid);
    copy_tile<D, THREADS>(Qs(s) + TF, dou + (rbase + r0) * D, tid);
    const uint32_t* src = mbits + (rbase + r0) * n_words;
    for (int i = tid; i < BQ * n_words; i += THREADS) cp_async4(Ms(s) + i, src + i);
  };
  // row tid's terms of the sub-tile whose first global row is grow0
  auto put_terms = [&](int s, int grow0, float l, float dlt) {
    const float w = (float)(grow0 + tid + 1);
    Rs(s)[tid] = make_float4(__fmul_rn(l, LOG2E), dlt, w, sea::recip(w));
  };

  int e = 0, r0 = -1, stage = 0;
  bool have = seek(e, r0);
  if (have) {
    load_q(0, r0);
    if (tid < BQ) put_terms(0, grow_of(e, r0), lse[rbase + r0 + tid], delta[rbase + r0 + tid]);
  }
  cp_async_commit();
  while (have) {
    int ne = e, nr0 = r0 + BQ;
    const bool more = seek(ne, nr0);
    // the next sub-tile's copies, and its lse and delta, load while this
    // one's products run
    float nl = 0.f, nd = 0.f;
    if (more) {
      load_q(stage ^ 1, nr0);
      if (tid < BQ) {
        nl = lse[rbase + nr0 + tid];
        nd = delta[rbase + nr0 + tid];
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage (and, first time, K and V) landed
    const float* Qt = Qs(stage);
    const float* Ot = Qt + TF;
    const uint32_t* Mt = Ms(stage);
    const float4* Rt = Rs(stage);
    const int grow0 = grow_of(e, r0);

    // The sub-tile's rows in PARTS parts of 8·NJ rows (one at width 64, two
    // at 80 and 128, where the four fragment sets of a whole sub-tile would
    // spill): each part's terms are made and summed into dk and dv before
    // the next part's, and every sum still takes the rows in increasing
    // order, so the parts change no bit.
#pragma unroll 1
    for (int part = 0; part < PARTS; ++part) {
      const int j0 = part * NJ;  // the part's first fragment row
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: st[j], dpt[j] the C fragments of the
      // sub-tile's rows 8·(j0 + j) .. 8·(j0 + j) + 7
      float st[NJ][4], dpt[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int d = 8 * kk + 2 * t4;
        uint32_t kh[4], kl[4], vh[4], vl[4];
        split_a(ld2<D>(Ks, wcol0 + g, d), ld2<D>(Ks, wcol0 + g + 8, d), kh, kl);
        split_a(ld2<D>(Vs, wcol0 + g, d), ld2<D>(Vs, wcol0 + g + 8, d), vh, vl);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 qf = ld2<D>(Qt, 8 * (j0 + j) + g, d);
          const float2 of = ld2<D>(Ot, 8 * (j0 + j) + g, d);
          mma_3xtf32(st[j], kh, kl, qf.x, qf.y);
          mma_3xtf32(dpt[j], vh, vl, of.x, of.y);
        }
      }

      // the element predicate, Pᵀ and dSᵀ: element (j, b) of fragment row h
      // is (column gc[h], sub-tile row 8·(j0 + j) + 2·t4 + b)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int rl = 8 * (j0 + j) + 2 * t4 + b;
          const float4 rt = Rt[rl];  // lse·log2 e, delta, width, reciprocal
          const uint32_t* words = Mt + rl * n_words;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& pt = st[j][2 * h + b];
            const float pv = alive_elem_recip(words, xc[h], gc[h], grow0 + rl, rt.z, rt.w, t_m)
                                 ? exp2_sfu(__fmaf_rn(pt, LOG2E, -rt.x)) : 0.f;
            pt = pv;
            dpt[j][2 * h + b] = pv * (dpt[j][2 * h + b] - rt.y);
          }
        }

      // dv += Pᵀ·dO and dk += dSᵀ·Q over the warp's columns d0 .. d0 + DH − 1,
      // Pᵀ and dSᵀ from their C fragments (k = the part's rows)
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_a(make_float2(st[kk][0], st[kk][1]), make_float2(st[kk][2], st[kk][3]), ph, pl);
        split_a(make_float2(dpt[kk][0], dpt[kk][1]), make_float2(dpt[kk][2], dpt[kk][3]), dh,
                dl);
        const int c = 8 * (j0 + kk) + 2 * t4;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const int n = d0 + 8 * j + g;
          mma_3xtf32(acc_v[j], ph, pl, Ot[c * LDD + n], Ot[(c + 1) * LDD + n]);
          mma_3xtf32(acc_k[j], dh, dl, Qt[c * LDD + n], Qt[(c + 1) * LDD + n]);
        }
      }
    }
    if (more && tid < BQ) put_terms(stage ^ 1, grow_of(ne, nr0), nl, nd);
    __syncthreads();  // this stage is consumed; the next one's terms are in
    e = ne;
    r0 = nr0;
    have = more;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long o = koff + (long)(wcol0 + g + 8 * h) * D + d0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<float2*>(dk + o + 8 * j) = make_float2(acc_k[j][2 * h], acc_k[j][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + o + 8 * j) = make_float2(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  }
}

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

// col_base: the global column of k's and v's first row (0 for K3 and K4).
// D: the head width; T: the element type of q, k, v, dou and the gradients
// (float: the mma.sync body; __nv_bfloat16: the wgmma body, 128-row tiles,
// so t_dst a multiple of 128); lse and delta are float32 either way.
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
  if constexpr (std::is_same<T, float>::value) {
    cudaError_t e = sea::opt_in_smem(causal_dq_kernel<D>, DQ_SMEM<D>, opted_in);
    if (e != cudaSuccess) return e;
    dim3 grid(nh, t_dst / BQ);
    causal_dq_kernel<D><<<grid, TPB, DQ_SMEM<D>, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const uint32_t*)mbits,
        (const float*)dou, (const float*)lse, (const float*)delta, (const int*)counts,
        (const int*)idx, (const int*)rowbase, (float*)dq, t_dst, t_src, t_m, n_words, block_q,
        block_k, nq, nkb, col_base);
  } else {
    const int bytes = wg::DqLayout<D>::FIXED + wg::CONSUMERS * nkb * 4;
    if (t_dst % wg::BLOCK != 0 || bytes > wg::SMEM_MAX || misaligned(mbits))
      return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv, tdo;
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

// The same for dk/dv (bf16: 128-column tiles, so t_src a multiple of 128).
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
  if constexpr (std::is_same<T, float>::value) {
    cudaError_t e = sea::opt_in_smem(causal_dkv_kernel<D>, DKV_SMEM<D>, opted_in);
    if (e != cudaSuccess) return e;
    dim3 grid(nh, t_src / BKT);
    causal_dkv_kernel<D><<<grid, DKV_TPB<D>, DKV_SMEM<D>, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const uint32_t*)mbits,
        (const float*)dou, (const float*)lse, (const float*)delta, (const int*)counts_t,
        (const int*)idx_t, (const int*)rowbase, (float*)dk, (float*)dv, t_dst, t_src, t_m,
        n_words, block_q, block_k, nq, nkb, col_base);
  } else {
    const int bytes = wg::DkvLayout<D>::FIXED + wg::CONSUMERS * nq * 4;
    if (t_src % wg::BLOCK != 0 || bytes > wg::SMEM_MAX || misaligned(mbits, lse, delta))
      return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv, tdo;
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
