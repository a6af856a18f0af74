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
// package does. The element mask is the forward body's, from sea_mask.cuh
// (`causal_pixel_recip`), so all three kernels agree on it bit for bit.
//
// Design (float32; bf16 below). Both kernels are FlashAttention-2's backward
// on mma.sync, float32 as split TF32 ("3xTF32", as the forward body: each
// operand hi + lo in TF32, a·b summed as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
// with m16n8k8 TF32 mmas into float32, each product to about 2^-21 of its
// size). A block is 4
// warps (128 threads); every product is one of the forward's two shapes
// (sea_mma.cuh): Q·Kᵀ-shaped, with both operands read as float2 along d, or
// P·V-shaped, with the A operand a C fragment as it stands and B read down
// its columns. So no score tile goes through shared memory.
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
//     but take immediate offsets, which ran faster than an unpadded layout
//     permuted to avoid them. dq takes 112 KB (two blocks an SM), dk/dv 118
//     KB (one), at width 64; at 80 dq takes 136 KB (one) and dk/dv 142 KB.
//   * Head widths: the bodies are templated on D, the padded row stride
//     LD<D> = D + 8 included; K3 and K4 are built at D = 64 and D = 80
//     (OPT-2.7b) in both types and pick the instance by head_dim at launch
//     (`sea::dispatch`); K7 and K8 take 64 only. At 80 the float32 row reads
//     stay conflict-free (rows g = 0..3 of a half-warp on banks 24·g + 2·t
//     mod 32) and the column reads two-way, as at 64 (rows 2·t on banks 16·t
//     + g mod 32); bf16 rows of 176 bytes put ldmatrix's 8 rows, plain or
//     transposed, on disjoint 4-bank groups (12·i mod 32).
//   * The splits round by integer operations (`sea::to_tf32_rna`: cvt.rna's
//     bits without its NaN and infinity checks, which cost more than any
//     other part of the splits).
//   * The predicate is the forward's: the pixel quotient from each row's
//     reciprocal (`sea::causal_pixel_recip`, IEEE division's bits), no
//     division per element; exp is 2^x on the SFU.
//   * Deterministic: no atomics, no row (dq) or column (dk/dv) split across
//     blocks, every sum in a fixed order. A dead sub-tile gives P = dS = 0
//     exactly and so adds exact zeros: lists of other block sizes (or a
//     shard that never lists it) give the same bits.
//
// bfloat16 (K3 and K4, and their instances under the window entries K7 and
// K8). The JAX kernels take bf16 operands, and round P and dS to bf16 before their
// products (`ds.astype(k_ref.dtype)`, `p.astype(do_ref.dtype)`); outputs come
// back in q's type. These instances keep the float32 bodies' walk, predicate,
// row terms and epilogue, and change only the element type and the products:
//   * Q, K, V and dO tiles are bf16, half the float32 bytes. The operand
//     that stays for the whole block lives in registers as mma A fragments,
//     read once from global memory (dq: Q and dO, 32 registers; dk/dv: K and
//     V), as the forward keeps Q; the tiles that walk go through shared
//     memory, rows padded by 16 bytes so that ldmatrix is free of bank
//     conflicts. dq takes 40 KB and dk/dv 46 KB of shared memory (float32:
//     112 and 118 KB), so shared memory no longer caps the blocks an SM
//     holds: the register cap of two blocks (255 a thread) does, which gives
//     dk/dv two blocks an SM where float32 fits one.
//   * Every product is an m16n8k16 bf16 mma with float32 sums: S = Q·Kᵀ and
//     dP = dO·Vᵀ (dk/dv: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ) are exact products of the
//     bf16 operands summed in float32; B operands come by ldmatrix (rows of
//     the walking tile for S and dP, transposed for dS·K, Pᵀ·dO and dSᵀ·Q).
//   * P and dS (Pᵀ, dSᵀ) are float32 and are split into bf16 hi + lo, two
//     mmas into the same sum, small terms first, as the forward splits P.
//     Each product then keeps about 2^-16 of its size where one rounding
//     of P or dS (JAX's) would cost 2^-9: the gradients track the float32
//     plain version on the same bf16 operands, rounded once to bf16.
//

// What bounds them on this card. As functions they are bound by bytes: per
// alive element dq needs 6·D FLOPs and dk/dv 8·D, and at the main path's
// densities (6-12% of the causal triangle) reading q, k, v, dO, the mask
// bits, lse and delta once and writing the gradients at 3.35 TB/s takes
// longer than that work at the FP32 FMA peak (67 TFLOP/s). The kernels are
// far from it: they do dense work on every visited 64 x 64 tile, three
// (dq) or four (dk/dv) products of three TF32 mmas each, the predicate of
// some 20 instructions per element, and read each visited sub-tile from L2
// once per tile of the other side. TMA, wgmma and gathering alive columns
// are later work.

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
using sea::ldsm_x4;
using sea::ldsm_x4_trans;
using sea::LOG2E;
using sea::MAX_DEVICES;
using sea::MAX_WORDS;
using sea::misaligned;
using sea::mma_3xtf32;
using sea::mma_bf16;
using sea::split_a;
using sea::split_bf16;

constexpr int BQ = sea::TILE;   // query rows per tile
constexpr int BKT = sea::TILE;  // key columns per tile
constexpr int TPB = 128;        // 4 warps of 16 rows (dq) or 16 columns (dk/dv)
template <int D>
constexpr int LD = D + 8;  // elements of a padded tile row
template <int D>
constexpr int TILE_F = 64 * LD<D>;  // elements of one tile

template <typename T>
constexpr bool IS_F32 = std::is_same<T, float>::value;
template <int D, typename T>
constexpr int TILE_BYTES = TILE_F<D> * (int)sizeof(T);

// dq: two stages of (K, V), then (float32) Q, dO, then the mask words.
template <int D, typename T>
constexpr int DQ_SMEM = (IS_F32<T> ? 6 : 4) * TILE_BYTES<D, T> + BQ * MAX_WORDS * 4;
// dk/dv: (float32) K, V, then two stages of (Q, dO, mask words, row terms).
template <int D, typename T>
constexpr int DKV_STAGE = 2 * TILE_BYTES<D, T> + BQ * MAX_WORDS * 4 + BQ * 16;
template <int D, typename T>
constexpr int DKV_SMEM = (IS_F32<T> ? 2 * TILE_BYTES<D, T> : 0) + 2 * DKV_STAGE<D, T>;
// float32 dk/dv fills an SM's shared memory with one block; bf16 fits two
template <typename T>
constexpr int DKV_MIN_BLOCKS = IS_F32<T> ? 1 : 2;

template <int D>
__device__ __forceinline__ float2 ld2(const float* tile, int c, int d) {
  return *reinterpret_cast<const float2*>(tile + c * LD<D> + d);
}

// 64 rows of D elements into a tile
template <int D, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src, int tid) {
  copy_rows<D, TPB>(dst, LD<D>, src, tid);
}

// bf16: the A fragments of 16 rows (r0 and r0 + 8 for the thread's g) of a
// (64, D) tile in global memory, k-step j's four registers
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const __nv_bfloat16* __restrict__ r0, int t4) {
  const __nv_bfloat16* r1 = r0 + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    a[j][0] = *reinterpret_cast<const uint32_t*>(r0 + 16 * j + 2 * t4);
    a[j][1] = *reinterpret_cast<const uint32_t*>(r1 + 16 * j + 2 * t4);
    a[j][2] = *reinterpret_cast<const uint32_t*>(r0 + 16 * j + 8 + 2 * t4);
    a[j][3] = *reinterpret_cast<const uint32_t*>(r1 + 16 * j + 8 + 2 * t4);
  }
}

// bf16: c[n] += A·Bᵀ for the 8·N rows of a shared tile `b` (B's columns n:
// tile rows 8·n .. 8·n + 7, k: d), A the fragments `a` of 16 rows by D
template <int D, int N>
__device__ __forceinline__ void mma_rows(float (&c)[N][4], const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < N / 2; ++jp) {
      // matrices: (rows 16·jp + 0..7, d + 0..7), (.., d + 8..15),
      // (rows + 8..15, d + 0..7), (.., d + 8..15)
      uint32_t f[4];
      ldsm_x4(f, b + (16 * jp + ((lane >> 4) << 3) + (lane & 7)) * LD<D> + 16 * kk +
                     (((lane >> 3) & 1) << 3));
      mma_bf16(c[2 * jp], a[kk], f[0], f[1]);
      mma_bf16(c[2 * jp + 1], a[kk], f[2], f[3]);
    }
}

// bf16: c[n] += X·B over the 8·N rows of a shared tile `b` (k: tile rows,
// B's columns n: d), X the float32 C fragments `x` (16 rows by the 8·N k)
// split into bf16 hi + lo, the lo product first
template <int D, int N>
__device__ __forceinline__ void mma_split(float (&c)[D / 8][4], const float (&x)[N][4],
                                          const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    // k = 16·kk .. 16·kk + 15 are C fragments 2·kk and 2·kk + 1
    uint32_t ah[4], al[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], ah[0], al[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], ah[1], al[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], ah[2], al[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      // matrices (transposed): (k + 0..7, d 16·jp + 0..7), (k + 8..15, ..),
      // (k + 0..7, d + 8..15), (k + 8..15, ..)
      uint32_t f[4];
      ldsm_x4_trans(f, b + (16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7)) * LD<D> +
                           16 * jp + ((lane >> 4) << 3));
      mma_bf16(c[2 * jp], al, f[0], f[1]);
      mma_bf16(c[2 * jp], ah, f[0], f[1]);
      mma_bf16(c[2 * jp + 1], al, f[2], f[3]);
      mma_bf16(c[2 * jp + 1], ah, f[2], f[3]);
    }
  }
}

// the thread's two elements (x0, x1) of a C fragment row into `o` (float32
// or rounded to bf16)
template <typename T>
__device__ __forceinline__ void store2(T* o, float x0, float x1) {
  if constexpr (IS_F32<T>)
    *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
  else
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
}

template <int D, typename T>
__global__ void __launch_bounds__(TPB, 2) causal_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint32_t* __restrict__ mbits,
    const T* __restrict__ dou, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts,
    const int* __restrict__ idx, const int* __restrict__ rowbase,
    T* __restrict__ dq, int t_dst, int t_src, int t_m, int n_words,
    int block_q, int block_k, int nq, int nkb, int col_base) {
  static_assert(D % 16 == 0, "head width");
  constexpr bool F32 = IS_F32<T>;
  constexpr int LDD = LD<D>, TF = TILE_F<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const kv_st = reinterpret_cast<T*>(smem);  // stage s: K, then V
  T* const Qs = kv_st + 4 * TF;                  // float32 only
  T* const Os = Qs + TF;
  uint32_t* const Ms = reinterpret_cast<uint32_t*>(smem + (F32 ? 6 : 4) * TILE_BYTES<D, T>);

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
  // float32: Q and dO tiles in shared memory; bf16: their A fragments
  uint32_t qa[D / 16][4], oa[D / 16][4];
  if constexpr (F32) {
    copy_tile<D>(Qs, q + qoff, tid);
    copy_tile<D>(Os, dou + qoff, tid);
  } else {
    load_a<D>(qa, q + qoff + (long)(wrow0 + g) * D, t4);
    load_a<D>(oa, dou + qoff + (long)(wrow0 + g) * D, t4);
  }

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
    T* Kd = kv_st + stage * 2 * TF;
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
    const T* Ks = kv_st + stage * 2 * TF;
    const T* Vs = Ks + TF;

    // S = Q·Kᵀ and dP = dO·Vᵀ: s[j], dp[j] the C fragments of score
    // columns 8·j .. 8·j + 7
    float s[BKT / 8][4], dp[BKT / 8][4];
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int d = 8 * kk + 2 * t4;
        uint32_t qh[4], ql[4], oh[4], ol[4];
        split_a(ld2<D>(Qs, wrow0 + g, d), ld2<D>(Qs, wrow0 + g + 8, d), qh, ql);
        split_a(ld2<D>(Os, wrow0 + g, d), ld2<D>(Os, wrow0 + g + 8, d), oh, ol);
#pragma unroll
        for (int j = 0; j < BKT / 8; ++j) {
          const float2 kf = ld2<D>(Ks, 8 * j + g, d);
          const float2 vf = ld2<D>(Vs, 8 * j + g, d);
          mma_3xtf32(s[j], qh, ql, kf.x, kf.y);
          mma_3xtf32(dp[j], oh, ol, vf.x, vf.y);
        }
      }
    } else {
      mma_rows<D>(s, qa, Ks, lane);
      mma_rows<D>(dp, oa, Vs, lane);
    }

    // the element predicate, P and dS, row by row: element (j, b) of row h
    // is column c0 + 8·j + 2·t4 + b
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wrow0 + g + 8 * h;
      const int r = grow0 + rl;
      const uint32_t* words = Ms + rl * n_words;
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = c0 + 8 * j + 2 * t4 + b;
          const float x = __fadd_rn((float)col, 0.5f);
          float& sv = s[j][2 * h + b];
          // off the mask P is exactly 0 (an empty row's lse = +inf never
          // meets a score)
          const float p = alive_elem_recip(words, x, col, r, wf[h], yw[h], t_m)
                              ? exp2_sfu(__fmaf_rn(sv, LOG2E, -l2[h])) : 0.f;
          sv = p * (dp[j][2 * h + b] - dl[h]);
        }
    }

    // dq += dS·K, dS from the S fragments (k = the sub-tile's columns)
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < BKT / 8; ++kk) {
        uint32_t ah[4], al[4];
        split_a(make_float2(s[kk][0], s[kk][1]), make_float2(s[kk][2], s[kk][3]), ah, al);
        const int c = 8 * kk + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          mma_3xtf32(acc[j], ah, al, Ks[c * LDD + 8 * j + g], Ks[(c + 1) * LDD + 8 * j + g]);
      }
    } else {
      mma_split<D>(acc, s, Ks, lane);
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
    T* o = dq + qoff + (long)(wrow0 + g + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(o + 8 * j, acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(TPB, DKV_MIN_BLOCKS<T>) causal_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint32_t* __restrict__ mbits,
    const T* __restrict__ dou, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts_t,
    const int* __restrict__ idx_t, const int* __restrict__ rowbase,
    T* __restrict__ dk, T* __restrict__ dv, int t_dst, int t_src,
    int t_m, int n_words, int block_q, int block_k, int nq, int nkb,
    int col_base) {
  static_assert(D % 16 == 0, "head width");
  constexpr bool F32 = IS_F32<T>;
  constexpr int STAGE = DKV_STAGE<D, T>;
  constexpr int LDD = LD<D>, TF = TILE_F<D>, TB = TILE_BYTES<D, T>;
  constexpr int PARTS = D > 64 ? 2 : 1;  // see the sub-tile's loop
  constexpr int NJ = BQ / 8 / PARTS;      // fragment rows of a part
  extern __shared__ __align__(16) unsigned char smem[];
  T* const Ks = reinterpret_cast<T*>(smem);  // float32 only
  T* const Vs = Ks + TF;
  // stage s: Q, dO, the mask words, then per row (lse·log2 e, delta, the
  // causal width, its reciprocal)
  unsigned char* const q_st = smem + (F32 ? 2 * TB : 0);
  auto Qs = [&](int s) { return reinterpret_cast<T*>(q_st + s * STAGE); };
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
  const int wcol0 = (tid >> 5) * 16;  // the warp's first column in the tile

  const long koff = ((long)bh * t_src + col0) * D;
  // float32: K and V tiles in shared memory; bf16: their A fragments
  uint32_t ka[D / 16][4], va[D / 16][4];
  if constexpr (F32) {
    copy_tile<D>(Ks, k + koff, tid);
    copy_tile<D>(Vs, v + koff, tid);
  } else {
    load_a<D>(ka, k + koff + (long)(wcol0 + g) * D, t4);
    load_a<D>(va, v + koff + (long)(wcol0 + g) * D, t4);
  }

  // per fragment row h: the k-tile column wcol0 + g + 8·h, global, and its
  // exact (float)col + 0.5
  int gc[2];
  float xc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gc[h] = gcol0 + wcol0 + g + 8 * h;
    xc[h] = __fadd_rn((float)gc[h], 0.5f);
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
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
    copy_tile<D>(Qs(s), q + (rbase + r0) * D, tid);
    copy_tile<D>(Qs(s) + TF, dou + (rbase + r0) * D, tid);
    const uint32_t* src = mbits + (rbase + r0) * n_words;
    for (int i = tid; i < BQ * n_words; i += TPB) cp_async4(Ms(s) + i, src + i);
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
    const T* Qt = Qs(stage);
    const T* Ot = Qt + TF;
    const uint32_t* Mt = Ms(stage);
    const float4* Rt = Rs(stage);
    const int grow0 = grow_of(e, r0);

    // The sub-tile's rows in PARTS parts of 8·NJ rows (one at width 64, two
    // at 80, where the four fragment sets of a whole sub-tile would spill):
    // each part's terms are made and summed into dk and dv before the next
    // part's, and every sum still takes the rows in increasing order, so
    // the parts change no bit.
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
      if constexpr (F32) {
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
      } else {
        mma_rows<D>(st, ka, Qt + 8 * j0 * LDD, lane);
        mma_rows<D>(dpt, va, Ot + 8 * j0 * LDD, lane);
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

      // dv += Pᵀ·dO and dk += dSᵀ·Q, Pᵀ and dSᵀ from their C fragments
      // (k = the part's rows)
      if constexpr (F32) {
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          uint32_t ph[4], pl[4], dh[4], dl[4];
          split_a(make_float2(st[kk][0], st[kk][1]), make_float2(st[kk][2], st[kk][3]), ph, pl);
          split_a(make_float2(dpt[kk][0], dpt[kk][1]), make_float2(dpt[kk][2], dpt[kk][3]), dh,
                  dl);
          const int c = 8 * (j0 + kk) + 2 * t4;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int n = 8 * j + g;
            mma_3xtf32(acc_v[j], ph, pl, Ot[c * LDD + n], Ot[(c + 1) * LDD + n]);
            mma_3xtf32(acc_k[j], dh, dl, Qt[c * LDD + n], Qt[(c + 1) * LDD + n]);
          }
        }
      } else {
        mma_split<D>(acc_v, st, Ot + 8 * j0 * LDD, lane);
        mma_split<D>(acc_k, dpt, Qt + 8 * j0 * LDD, lane);
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
    const long o = koff + (long)(wcol0 + g + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dk + o + 8 * j, acc_k[j][2 * h], acc_k[j][2 * h + 1]);
      store2(dv + o + 8 * j, acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  }
}

// col_base: the global column of k's and v's first row (0 for K3 and K4).
// D: the head width; T: the element type of q, k, v, dou and the gradients
// (float or __nv_bfloat16); lse and delta are float32 either way.
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
  cudaError_t e = sea::opt_in_smem(causal_dq_kernel<D, T>, DQ_SMEM<D, T>, opted_in);
  if (e != cudaSuccess) return e;
  dim3 grid(nh, t_dst / BQ);
  causal_dq_kernel<D, T><<<grid, TPB, DQ_SMEM<D, T>, stream>>>(
      (const T*)q, (const T*)k, (const T*)v,
      (const uint32_t*)mbits, (const T*)dou, (const float*)lse,
      (const float*)delta, (const int*)counts, (const int*)idx,
      (const int*)rowbase, (T*)dq, t_dst, t_src, t_m, n_words, block_q,
      block_k, nq, nkb, col_base);
  return cudaGetLastError();
}

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
  cudaError_t e = sea::opt_in_smem(causal_dkv_kernel<D, T>, DKV_SMEM<D, T>, opted_in);
  if (e != cudaSuccess) return e;
  dim3 grid(nh, t_src / BKT);
  causal_dkv_kernel<D, T><<<grid, TPB, DKV_SMEM<D, T>, stream>>>(
      (const T*)q, (const T*)k, (const T*)v,
      (const uint32_t*)mbits, (const T*)dou, (const float*)lse,
      (const float*)delta, (const int*)counts_t, (const int*)idx_t,
      (const int*)rowbase, (T*)dk, (T*)dv, t_dst, t_src, t_m, n_words,
      block_q, block_k, nq, nkb, col_base);
  return cudaGetLastError();
}

}  // namespace

// K3: dq (nh, t_dst, D) in q's type, float32 or bf16 (is_bf16); head width
// 64 or 80.
extern "C" int sea_causal_dq(const void* q, const void* k, const void* v,
                             const void* mbits, const void* dou,
                             const void* lse, const void* delta,
                             const void* counts, const void* idx,
                             const void* rowbase, void* dq, int nh, int t_dst,
                             int t_src, int head_dim, int t_m, int n_words,
                             int block_q, int block_k, int nq, int nkb,
                             int is_bf16, void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(head_dim, is_bf16, [&](auto d, auto t) {
    return launch_dq<decltype(d)::value, typename decltype(t)::type>(
        q, k, v, mbits, dou, lse, delta, counts, idx, rowbase, dq, nh, t_dst, t_src, t_m,
        n_words, block_q, block_k, nq, nkb, 0, (cudaStream_t)stream);
  });
}

// K4: dk, dv (nh, t_src, D) in q's type, float32 or bf16 (is_bf16); head
// width 64 or 80.
extern "C" int sea_causal_dkv(const void* q, const void* k, const void* v,
                              const void* mbits, const void* dou,
                              const void* lse, const void* delta,
                              const void* counts_t, const void* idx_t,
                              const void* rowbase, void* dk, void* dv, int nh,
                              int t_dst, int t_src, int head_dim, int t_m,
                              int n_words, int block_q, int block_k, int nq,
                              int nkb, int is_bf16, void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(head_dim, is_bf16, [&](auto d, auto t) {
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
  if (bad_geometry(head_dim, n_words, t_dst, t_win, block_q, block_k) || head_dim != 64 ||
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
  if (bad_geometry(head_dim, n_words, t_dst, t_win, block_q, block_k) || head_dim != 64 ||
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
