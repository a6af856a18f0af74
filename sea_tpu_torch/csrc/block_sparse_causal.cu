// Fused block-sparse SEA attention forward kernels for Hopper (sm_90a): the
// causal forward, its forward-with-stats variant, the padded bidirectional
// forward and the causal forward's three impl variants, instances of one
// kernel body.
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
//     global columns, and only the K/V loads subtract col_base. The scaler is
//     one (the ring applies the real one after merging the windows), and a
//     row with nothing alive in the window gets lse = +inf and a zero output,
//     as in K2. K1, K2 and K5 pass col_base = 0 and their whole K/V;
//   * the variants that `sea_block_sparse_attention(..., impl=)` selects,
//     each K1's function with a restricted element predicate (IMPL): entry
//     points `sea_causal_word_range_forward` (K9a, `_causal_kernel_flat_wr`,
//     impl "flat_wr"), `sea_causal_word_loop_forward` (K9b,
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
// about 6-12% of the causal triangle, so reading q, k, v, the mask bits and
// the scaler once and writing out at HBM's 3.35 TB/s takes longer than the
// alive work. The kernel does not gather alive columns: it does dense work on
// every visited 64 x 64 tile (4·64·64·D FLOPs), and the 64 x 64 lists keep
// nearly the whole triangle on these masks. So its time goes to the two
// products of every visited tile, which are the work tensor cores are for,
// to the element predicate and the softmax's exp, both per element on the
// ALU and SFU pipes, and to reading each visited K/V sub-tile from L2 once
// per q-tile. On bench.py's shapes in bf16 the predicate is the largest of
// the parts measured (PERF.md).
//
// Design. One thread block of 4 warps (128 threads) per (batch·head, 64-row
// q-tile); blocks start with every head's last q-tile, the heaviest causal
// one, and end with the first, so that the light blocks fill the tail. It
// walks the q-block's list of active k-blocks (`counts`/`idx`, a
// conservative superset built on the host side) in 64-column sub-tiles, in
// increasing order, and skips sub-tiles that lie wholly past the tile's last
// row (bidirectional: past the example's length). The body is
// FlashAttention-2's, on mma.sync:
//   * each warp owns 16 query rows, and keeps the row max m, the row sum l
//     and the output accumulator (the mma C fragments, float32) of its rows;
//     a thread holds two rows (g and g + 8 of the warp's 16) and, of each,
//     the columns 8·j + 2·(lane % 4) + {0, 1};
//   * K/V sub-tiles arrive by cp.async (16 bytes a thread) in a ring of two
//     stages, so that the next listed sub-tile loads while this one's
//     products run;
//   * S = Q·Kᵀ on the tensor cores; then the element predicate per element
//     in the fragment layout (a dead element goes to −inf before the row
//     max, so exp is taken of alive scores only), the online-softmax update
//     with row reductions as shuffles inside each lane quad, and P·V with P
//     re-packed from the S fragments as the A operand, never through shared
//     memory;
//   * bfloat16 (FMA-free products): Q's fragments in registers for the
//     whole tile, m16n8k16 bf16 mmas with float32 sums, K and V operands by
//     ldmatrix from shared rows padded by 16 bytes (conflict free). The
//     products of bf16 values are exact in float32. P is split as P_hi =
//     bf16(P) and P_lo = bf16(P − P_hi), two mmas into the same accumulator
//     (relative error about 2^-16, where a single rounding of P would cost
//     2^-9 and break the half-ulp gate on cancelling rows);
//   * float32: split TF32 ("3xTF32"), Q in shared memory (its fragments
//     would take the registers the split needs). Each operand is hi + lo in
//     TF32 (cvt.rna), and a·b is summed as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
//     with m16n8k8 TF32 mmas into float32, for both products; the dropped
//     a_lo·b_lo and the rounding of the lo parts are about 2^-21 of a
//     product, so the result keeps float32 accuracy to a few 1e-7 (not the
//     3-digit TF32 of `allow_tf32`). The reduction index of each product is
//     permuted inside each 8-wide k-step (column 2·t and 2·t + 1 as k = t and
//     t + 4) so that the S fragment is the P·V A fragment as it stands and K
//     and Q are read as float2;
//   * the predicate keeps the element mask bit for bit and costs no branch:
//     each element's quotient (s + 0.5) / w comes from the row's reciprocal
//     by the fast path of IEEE division itself (`sea::quot`; chip_smoke holds
//     it equal to the division on every row width to 2^17), where a division
//     per element would cost a reciprocal, a range check and a slow-path
//     branch;
//   * exp(x − m) is 2^(x·log2 e − m·log2 e) on the SFU (ex2.approx, about
//     2^-22 relative), whose 2^0 is 1 exactly;
//   * deterministic: no atomics, no row split across blocks, each row's sums
//     in a fixed order. A sub-tile with no alive element leaves m, l and acc
//     exactly as they were (corr = 2^0 = 1, P = 0), so a variant that skips
//     it or a shard that never lists it gives the same bits.
// TMA, wgmma and warp specialisation are later work: mma.sync reaches part
// of the tensor cores' rate, and the predicate still costs some 20
// instructions per element of every visited tile.
//
// K6 walks the same lists restricted to one window: the ring launches it S
// times per shard (S² per layer), each over a 1/S slice of the columns, so
// its bound and its design are K2's on a smaller problem.
//
// K5 takes the same design. A BERT-base layer at 32 x 256 tokens is 1536
// blocks of one 64-row q-tile each, and the padded columns past each
// example's length are skipped whole sub-tiles at a time. Its bound is bytes
// as well (4·D FLOPs per alive element against q, k, v read once).
//
// The impl variants K9a-c. The TPU kernels select each element's packed mask
// word with a chain of vector selects over all T_M/32 words, the largest
// vector block of the flat kernel; their variants cut that chain. Here a
// thread indexes its row's word directly, so what carries over is which
// words a tile may read and which pieces it may skip. Each variant keeps K1's
// element mask bit for bit (`causal_pixel`, the pinned division form): the
// restriction only decides which words or pieces are read, and a word it
// leaves out counts as dead.
//   * K9a (WORD_RANGE) reads the tile's word range wr = lo | hi << 8 |
//     exact << 16 (`_tile_word_ranges`: corner evaluation padded by one
//     pixel, so the few-ulp gap between the TPU's reciprocal form and the
//     division form stays inside it). With `exact` and one or two words,
//     each thread takes each of its two rows' word from the candidates it
//     holds in registers for the sub-tile; otherwise the row's staged word,
//     dead outside lo .. hi. (The staged word is read either way, so that the
//     choice is a select, not a branch per element.)
//   * K9b (WORD_LOOP) keeps no shared-memory copy of the mask words: for each
//     of its two rows, a thread walks w = lo .. hi (a dynamic trip count of at
//     most 16), reads word w through L1 once and selects it into the 16
//     elements whose word it is, as the TPU's fori_loop body does. Against
//     K9a it saves the staging of 64 x n_words words per block and a
//     shared-memory lookup per element, and costs one global (L1) load per
//     word of the range, per row and sub-tile, and a compare-select per
//     element and word.
//   * K9c (SUBTILE) walks outer k-blocks (`block_k`, the JAX package's
//     auto_block width) and, inside each, visits only the `sub`-wide pieces
//     whose bit is set in the tile's `submask` (`tile_activity_sub`), skipping
//     the loads, Q·Kᵀ, the predicate and P·V of every other piece. When the
//     q-block's first row is wide enough (`sub_short`), a piece's pixels fall
//     in two words, and each thread loads the two candidates of its rows once
//     per piece (the TPU kernel's short path).
// Every variant walks the listed 64-column sub-tiles in increasing order
// through the same body, and a sub-tile with no alive element changes
// nothing, so each equals K1's output bit for bit on the same inputs. Their
// bound is K1's, by bytes; what they change is the predicate's cost per
// visited element (K9a, K9b) and the number of visited sub-tiles (K9c), not
// the bytes.
//
// Head widths. The body is templated on D; K1 and K2 (and so K6's
// instance) are built at D = 64 and D = 80 (OPT-2.7b), in both types, and
// pick the instance by head_dim at launch (`sea::dispatch`); K5, K6 and
// K9a-c take 64 only. At D = 80 a row is 160 bytes (bf16) or 320 (float32),
// whole 16-byte copies, and the padded strides below stay free of bank
// conflicts: bf16 rows of 88 elements (176 bytes) put ldmatrix's 8 rows on
// banks 12·i mod 32, disjoint 4-bank groups; float32 K and Q rows of 88
// floats put the float2 reads of rows g = 0..3 (one half-warp) on banks
// 24·g + 2·t mod 32, and V rows of 84 put the reads of rows 2·t on banks
// 8·t + g, as at 64.
//
// The element predicates live in sea_mask.cuh (`alive_elem`, `alive_elem_len`,
// and K9a-c's `alive_elem_wr`, `alive_elem_loop`, `alive_elem_sub`), shared
// with the backward kernels and with the debug kernels `alive_mask_kernel`
// and `impl_alive_mask_kernel`, which let the card check each bit for bit
// against the oracle.

#include <type_traits>

#include "sea_mask.cuh"
#include "sea_mma.cuh"

namespace {

using sea::alive_elem;
using sea::alive_elem_len;
using sea::bad_geometry;
using sea::bad_window;
using sea::copy_rows;
using sea::cp_async_commit;
using sea::cp_async_wait;
using sea::exp2_sfu;
using sea::ldsm_x4;
using sea::ldsm_x4_trans;
using sea::LOG2E;
using sea::MAX_DEVICES;
using sea::MAX_WORDS;
using sea::misaligned;
using sea::mma_bf16;
using sea::mma_tf32;
using sea::split_bf16;
using sea::split_tf32;

constexpr int BQ = sea::TILE;   // query rows per block
constexpr int BKT = sea::TILE;  // key columns per sub-tile
constexpr int WARPS = BQ / 16;  // each owns 16 query rows
constexpr int TPB = 32 * WARPS;
constexpr int NT = BKT / 8;     // 8-column score tiles of a sub-tile
constexpr float M_INIT = -1.0e30f;  // running-max floor: exp(-inf - m) == 0

// Which mask words the causal element predicate reads: all of the row's
// (K1, K2, K5, K6), the tile's word range staged (K9a) or walked (K9b), or
// the words of the active pieces only (K9c).
enum Impl : int { FLAT = 0, WORD_RANGE = 1, WORD_LOOP = 2, SUBTILE = 3 };

// Shared memory: two stages of (K, V) sub-tiles, then (float32) the q-tile,
// then its mask words. Row strides padded so that every fragment read is free
// of bank conflicts: bf16 rows by 16 bytes (ldmatrix's 8 rows of a matrix
// start on banks 4·i); float32 K and Q rows by 8 floats (float2 reads of rows
// g = 0..3 at banks 8·g + 2·t) and V rows by 4 (reads of rows 2·t at banks
// 8·t + g). bf16 keeps Q's fragments in registers (16 a thread); float32's
// would take 32 more than the split products leave.
template <int D, typename T>
struct Smem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int KLD = D + 8;
  static constexpr int VLD = F32 ? D + 4 : D + 8;
  static constexpr int K_BYTES = BKT * KLD * (int)sizeof(T);
  static constexpr int STAGE = K_BYTES + BKT * VLD * (int)sizeof(T);
  static constexpr int Q_BYTES = F32 ? BQ * KLD * 4 : 0;
  static constexpr int bytes = 2 * STAGE + Q_BYTES + BQ * MAX_WORDS * 4;
};

// One 64-column K/V sub-tile into a stage.
template <int D, typename T>
__device__ __forceinline__ void load_kv(unsigned char* stage, const T* __restrict__ k,
                                        const T* __restrict__ v, long base, int tid) {
  using S = Smem<D, T>;
  copy_rows<D, TPB>(reinterpret_cast<T*>(stage), S::KLD, k + base, tid);
  copy_rows<D, TPB>(reinterpret_cast<T*>(stage + S::K_BYTES), S::VLD, v + base, tid);
}

// Blocks an SM should hold, which caps registers at 65536 / (128·blocks):
// bf16 at width 64 fits three (168 registers, no spill) and overlaps their
// barriers; at 80 (Q's fragments 20 registers, the output's 40) K1 spilled
// at 168 and takes two; float32's split products need the 255 of two.
template <int D, typename T>
constexpr int MIN_BLOCKS = std::is_same<T, float>::value || D > 64 ? 2 : 3;

// STATS: the forward of the differentiable path. The undersampling predicate
// is off and `lse` receives each row's logsumexp.
// BIDIR: the padded bidirectional forward. Row widths come from `lengths`
// (one per batch·head); `rowbase` and the undersampling predicate are unused.
// IMPL: which mask words the element predicate reads (K9a-c; FLAT for the
// others). `tiles` (batch·head, nq, nkb) lies beside `idx`: each listed
// tile's word range (WORD_RANGE, WORD_LOOP) or bitmask of active `sub`-wide
// pieces (SUBTILE); FLAT reads neither.
template <int D, typename T, bool STATS, bool BIDIR, int IMPL = FLAT>
__global__ void __launch_bounds__(TPB, MIN_BLOCKS<D, T>) causal_flat_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint32_t* __restrict__ mbits, const float* __restrict__ scaler,
    const int* __restrict__ counts, const int* __restrict__ idx,
    const int* __restrict__ tiles, const int* __restrict__ rowbase,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ lse, int t_dst, int t_src, int t_m, int n_words,
    int block_q, int block_k, int nq, int nkb, int sub, float oversample,
    float k_cfg, float keep_lo, float keep_hi, int col_base) {
  using S = Smem<D, T>;
  constexpr bool F32 = S::F32;
  static_assert(D % 16 == 0, "head width");
  extern __shared__ __align__(16) unsigned char smem[];
  const float* Qs = reinterpret_cast<const float*>(smem + 2 * S::STAGE);  // float32
  uint32_t* Ms = reinterpret_cast<uint32_t*>(smem + 2 * S::STAGE + S::Q_BYTES);

  // blocks start in order of x, then y: every head's last (heaviest causal)
  // q-tile first, then the ones before it
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // first local row of the tile
  const int qb = row0 / block_q;     // q-block of the tile lists
  const int grow0 = BIDIR ? row0 : rowbase[qb] + (row0 - qb * block_q);
  const int len = BIDIR ? lengths[bh] : 0;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the fragment row and column pair
  const int wrow0 = (tid >> 5) * 16;       // the warp's first row in the tile

  const long moff = ((long)bh * t_dst + row0) * n_words;
  // WORD_LOOP reads its rows' words from global memory (L1) instead
  if (IMPL != WORD_LOOP)
    for (int i = tid; i < BQ * n_words; i += TPB) Ms[i] = mbits[moff + i];

  // bf16: Q's A fragments for the whole tile, k-step j's four registers
  // (rows g, g + 8; columns 16·j + 2·t4 (+8)). float32: the q-tile goes to
  // shared memory with the first K/V sub-tile.
  const long qoff = ((long)bh * t_dst + row0) * D;
  uint32_t qa[D / 16][4];
  if constexpr (F32) {
    copy_rows<D, TPB>(reinterpret_cast<T*>(smem + 2 * S::STAGE), S::KLD, q + qoff, tid);
  } else {
    const T* qr0 = q + qoff + (long)(wrow0 + g) * D;
    const T* qr1 = qr0 + 8 * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      qa[j][0] = *reinterpret_cast<const uint32_t*>(qr0 + 16 * j + 2 * t4);
      qa[j][1] = *reinterpret_cast<const uint32_t*>(qr1 + 16 * j + 2 * t4);
      qa[j][2] = *reinterpret_cast<const uint32_t*>(qr0 + 16 * j + 8 + 2 * t4);
      qa[j][3] = *reinterpret_cast<const uint32_t*>(qr1 + 16 * j + 8 + 2 * t4);
    }
  }

  // per fragment row h: rows wrow0 + g + 8·h of the tile; wf, the row's
  // width (causal r + 1, bidirectional the length) and yw its reciprocal
  float m_i[2], l_i[2], ps[2], thr[2], wf[2], yw[2];
  float acc[D / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_i[h] = M_INIT;
    l_i[h] = 0.f;
    const float w = (float)(grow0 + wrow0 + g + 8 * h + 1);
    wf[h] = BIDIR ? (float)len : w;
    yw[h] = sea::recip(wf[h]);
    ps[h] = fmaxf(floorf(__fadd_rn(__fdiv_rn(w, oversample), 0.5f)), 1.0f);
    const float oys = __fdiv_rn(fminf(fmaxf(w, keep_lo), keep_hi), k_cfg);
    thr[h] = __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, oys), 0.5f), 1e-4f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const bool undersample = !STATS && !BIDIR && oversample != 1.0f;
  const float dead = __uint_as_float(0xff800000u);  // -inf

  const int cnt = counts[bh * nq + qb];
  const int* lst = idx + ((long)bh * nq + qb) * nkb;
  const int* tls = tiles + ((long)bh * nq + qb) * nkb;  // read unless FLAT
  // SUBTILE: whether this q-block's rows take the two-candidate path
  const bool shrt = IMPL == SUBTILE && sea::sub_short(grow0 - (row0 - qb * block_q), t_m, sub);
  // every column from here on is dead on every row of the tile
  const int col_end = BIDIR ? len : grow0 + BQ;
  // k and v hold the (global) columns col_base .. col_stop − 1; col_stop and
  // every c0 are multiples of 64, so a visited sub-tile lies wholly inside
  const int col_stop = col_base + t_src;
  const long kvbase = ((long)bh * t_src - col_base) * D;

  // The walk: advance (e, c0) to the first visited sub-tile at or after it
  // (list entry e, first column c0); false when the list is done.
  auto seek = [&](int& e, int& c0) -> bool {
    for (; e < cnt; ++e, c0 = -1) {
      const int start = lst[e] * block_k;
      for (c0 = c0 < start ? start : c0; c0 < start + block_k; c0 += BKT) {
        // wholly past the causal edge, the length or the window
        if (c0 >= col_end || c0 >= col_stop) break;
        // SUBTILE skips the dead pieces whole: no loads, no Q·Kᵀ, no
        // predicate, no P·V
        if (IMPL == SUBTILE && ((((unsigned)tls[e]) >> ((c0 - start) / sub)) & 1u) == 0u)
          continue;
        return true;
      }
    }
    return false;
  };

  // SUBTILE: the rows' two candidates of the current piece, kept across its
  // sub-tiles; WORD_RANGE: the rows' one or two candidate words
  uint32_t cand0[2] = {0u, 0u}, cand1[2] = {0u, 0u};
  int cand_w[2] = {0, 0};

  int e = 0, c0 = -1, stage = 0;
  bool have = seek(e, c0);
  if (have) load_kv<D, T>(smem, k, v, kvbase + (long)c0 * D, tid);
  cp_async_commit();
  while (have) {
    int ne = e, nc0 = c0 + BKT;
    const bool more = seek(ne, nc0);
    // the next sub-tile's copies run while this one's products do
    if (more) load_kv<D, T>(smem + (stage ^ 1) * S::STAGE, k, v, kvbase + (long)nc0 * D, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage (and, first time, the mask words) landed
    const T* Ks = reinterpret_cast<const T*>(smem + stage * S::STAGE);
    const T* Vs = reinterpret_cast<const T*>(smem + stage * S::STAGE + S::K_BYTES);

    // S = Q·Kᵀ: s[j] is the C fragment of score columns 8·j .. 8·j + 7
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        // k = t4 is column 8·kk + 2·t4 of Q and K, k = t4 + 4 the one after
        const float2 qa0 =
            *reinterpret_cast<const float2*>(Qs + (wrow0 + g) * S::KLD + 8 * kk + 2 * t4);
        const float2 qa1 =
            *reinterpret_cast<const float2*>(Qs + (wrow0 + g + 8) * S::KLD + 8 * kk + 2 * t4);
        uint32_t ah[4], al[4];
        split_tf32(qa0.x, ah[0], al[0]);
        split_tf32(qa1.x, ah[1], al[1]);
        split_tf32(qa0.y, ah[2], al[2]);
        split_tf32(qa1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 kv =
              *reinterpret_cast<const float2*>(Ks + (8 * j + g) * S::KLD + 8 * kk + 2 * t4);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kv.x, bh0, bl0);
          split_tf32(kv.y, bh1, bl1);
          mma_tf32(s[j], al, bh0, bh1);
          mma_tf32(s[j], ah, bl0, bl1);
          mma_tf32(s[j], ah, bh0, bh1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          // matrices: (columns 16·jp + 0..7, d + 0..7), (.., d + 8..15),
          // (columns + 8..15, d + 0..7), (.., d + 8..15)
          uint32_t b[4];
          ldsm_x4(b, Ks + (16 * jp + ((lane >> 4) << 3) + (lane & 7)) * S::KLD + 16 * kk +
                         (((lane >> 3) & 1) << 3));
          mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
          mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
        }
      }
    }

    // WORD_RANGE, WORD_LOOP: the tile's word range; WORD_RANGE keeps each of
    // its rows' one or two candidate words in registers.
    // SUBTILE: the candidates at the first sub-tile of each piece.
    sea::WordRange wr{0, 0, false, false};
    if (IMPL == WORD_RANGE || IMPL == WORD_LOOP) wr = sea::word_range(tls[e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wrow0 + g + 8 * h;
      const uint32_t* words = Ms + rl * n_words;
      if (IMPL == WORD_RANGE && (wr.one || wr.two)) {
        cand0[h] = words[wr.lo];
        cand1[h] = wr.two ? words[wr.lo + 1] : 0u;
      }
      if (IMPL == SUBTILE && shrt && (c0 - lst[e] * block_k) % sub == 0)
        sea::sub_candidates(words, c0, grow0 + rl, t_m, n_words, cand_w[h], cand0[h],
                            cand1[h]);
    }

    // the element predicate and the online softmax, row by row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wrow0 + g + 8 * h;
      const int r = grow0 + rl;
      const uint32_t* words = Ms + rl * n_words;
      // element j's column is c0 + 8·(j / 2) + 2·t4 + j % 2, and its pixel
      // (causal: -1 where dead whatever the mask holds) comes from the row's
      // reciprocal; x0 + j's offset is the exact (float)col + 0.5
      const float x0 = __fadd_rn((float)(c0 + 2 * t4), 0.5f);
      auto pixel = [&](int j) {
        const int col = c0 + 8 * (j >> 1) + 2 * t4 + (j & 1);
        const float x = __fadd_rn(x0, (float)(8 * (j >> 1) + (j & 1)));
        return BIDIR ? sea::len_clip(sea::floor_pixel(sea::quot(x, wf[h], yw[h]), t_m), t_m)
                     : sea::causal_pixel_recip(x, col, r, wf[h], yw[h], t_m);
      };
      // WORD_LOOP: the words of the thread's 16 columns in one walk over the
      // range, each word read once through L1
      uint32_t lw[2 * NT];
      int lpix[2 * NT];
      if (IMPL == WORD_LOOP) {
        int wi[2 * NT];
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          lpix[j] = pixel(j);
          wi[j] = lpix[j] >= 0 ? lpix[j] >> 5 : -1;
        }
        sea::loop_words<2 * NT>(mbits + moff + (long)rl * n_words, wr.lo, wr.hi, wi, lw);
      }
      float rmax = M_INIT;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        const int col = c0 + 8 * (j >> 1) + 2 * t4 + (j & 1);
        const int pix = IMPL == WORD_LOOP ? lpix[j] : pixel(j);
        const int wi = (pix < 0 ? 0 : pix) >> 5;  // a word to read also when dead
        uint32_t word;
        if (IMPL == WORD_RANGE)
          word = sea::range_word(words, wi, wr, cand0[h], cand1[h]);
        else if (IMPL == WORD_LOOP)
          word = lw[j];
        else if (IMPL == SUBTILE)
          word = sea::sub_word(words, wi, shrt, cand_w[h], cand0[h], cand1[h]);
        else
          word = words[wi];
        bool a = (BIDIR ? col < len : pix >= 0) & sea::pixel_bit(word, pix);
        if (undersample)
          a = a & sea::keep_quot(sea::quot((float)(col + 1), wf[h], yw[h]), ps[h], thr[h]);
        float& x = s[j >> 1][2 * h + (j & 1)];
        x = a ? x : dead;
        rmax = fmaxf(rmax, x);
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
        float& x = s[j >> 1][2 * h + (j & 1)];
        x = exp2_sfu(__fmaf_rn(x, LOG2E, -ml));  // dead elements: 2^-inf == 0
        psum += x;
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

    // acc += P·V, P from the S fragments (k = the sub-tile's columns)
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        // k = t4 is column 8·kk + 2·t4, k = t4 + 4 is the one after
        uint32_t ah[4], al[4];
        split_tf32(s[kk][0], ah[0], al[0]);
        split_tf32(s[kk][2], ah[1], al[1]);
        split_tf32(s[kk][1], ah[2], al[2]);
        split_tf32(s[kk][3], ah[3], al[3]);
        const T* v0 = Vs + (8 * kk + 2 * t4) * S::VLD + g;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0[8 * j], bh0, bl0);
          split_tf32(v0[S::VLD + 8 * j], bh1, bl1);
          mma_tf32(acc[j], al, bh0, bh1);
          mma_tf32(acc[j], ah, bl0, bl1);
          mma_tf32(acc[j], ah, bh0, bh1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        // columns 16·kk .. 16·kk + 15 are score tiles 2·kk and 2·kk + 1
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int jp = 0; jp < D / 16; ++jp) {
          // matrices (transposed): (k + 0..7, d 16·jp + 0..7), (k + 8..15, ..),
          // (k + 0..7, d + 8..15), (k + 8..15, ..)
          uint32_t b[4];
          ldsm_x4_trans(b, Vs + (16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7)) * S::VLD +
                               16 * jp + ((lane >> 4) << 3));
          mma_bf16(acc[2 * jp], pl, b[0], b[1]);
          mma_bf16(acc[2 * jp], ph, b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], pl, b[2], b[3]);
          mma_bf16(acc[2 * jp + 1], ph, b[2], b[3]);
        }
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
    const int rl = wrow0 + g + 8 * h;
    const float l = l_i[h];
    const float safe_l = l > 0.f ? l : 1.f;
    const float sc = scaler ? scaler[(long)bh * t_dst + row0 + rl] : 1.f;
    T* o = out + qoff + (long)rl * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = acc[j][2 * h] / safe_l * sc;
      const float x1 = acc[j][2 * h + 1] / safe_l * sc;
      if constexpr (F32)
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
    // logsumexp; +inf for rows with no alive column, so that the backward's
    // exp(s - lse) is 0 there (m and l are equal across the lane quad)
    if (STATS && t4 == 0)
      lse[(long)bh * t_dst + row0 + rl] =
          l > 0.f ? m_i[h] + logf(l) : __uint_as_float(0x7f800000u);
  }
}

// BIDIR: the predicate of K5, with the width lengths[bh]; else that of K1.
template <bool BIDIR>
__global__ void alive_mask_kernel(const uint32_t* __restrict__ mbits,
                                  const int* __restrict__ lengths,
                                  int8_t* __restrict__ out, int t_dst,
                                  int t_src, int t_m, int n_words) {
  const int bh = blockIdx.z, r = blockIdx.y;
  const int len = BIDIR ? lengths[bh] : 0;
  const uint32_t* words = mbits + ((long)bh * t_dst + r) * n_words;
  int8_t* row = out + ((long)bh * t_dst + r) * t_src;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < t_src;
       s += gridDim.x * blockDim.x)
    row[s] = (BIDIR ? alive_elem_len(words, s, len, t_m)
                    : alive_elem(words, s, r, t_m)) ? 1 : 0;
}

// The restricted predicate of K9a-c alone, for a bit-for-bit check against
// the oracle. `tiles` (batch·head, nq, nkb) is dense over every (q-block,
// k-block): the listed tiles' word ranges, -1 where a tile is not listed
// (WORD_RANGE, WORD_LOOP), or their piece bitmasks, 0 where not listed
// (SUBTILE). Rows are global (no row base).
template <int IMPL>
__global__ void impl_alive_mask_kernel(const uint32_t* __restrict__ mbits,
                                       const int* __restrict__ tiles,
                                       int8_t* __restrict__ out, int t_dst,
                                       int t_src, int t_m, int n_words,
                                       int block_q, int block_k, int nq,
                                       int nkb, int sub) {
  const int bh = blockIdx.z, r = blockIdx.y;
  const int qb = r / block_q;
  const uint32_t* words = mbits + ((long)bh * t_dst + r) * n_words;
  const int* tl = tiles + ((long)bh * nq + qb) * nkb;
  int8_t* row = out + ((long)bh * t_dst + r) * t_src;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < t_src;
       s += gridDim.x * blockDim.x) {
    const int kb = s / block_k;
    const int aux = tl[kb];
    bool a;
    if (IMPL == SUBTILE) {
      const int piece = (s - kb * block_k) / sub;
      int wlo;
      uint32_t c0, c1;
      sea::sub_candidates(words, kb * block_k + piece * sub, r, t_m, n_words,
                          wlo, c0, c1);
      a = (((unsigned)aux >> piece) & 1u) &&
          sea::alive_elem_sub(words, s, r, t_m,
                              sea::sub_short(qb * block_q, t_m, sub), wlo, c0, c1);
    } else {
      const sea::WordRange g = sea::word_range(aux);
      if (IMPL == WORD_LOOP) {
        a = aux >= 0 && sea::alive_elem_loop(words, s, r, t_m, g);
      } else {
        const bool fast = aux >= 0 && (g.one || g.two);  // -1: not listed
        const uint32_t c0 = fast ? words[g.lo] : 0u;
        const uint32_t c1 = fast && g.two ? words[g.lo + 1] : 0u;
        a = aux >= 0 && sea::alive_elem_wr(words, s, r, t_m, g, c0, c1);
      }
    }
    row[s] = a ? 1 : 0;
  }
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
  constexpr int bytes = Smem<D, T>::bytes;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  cudaError_t e = sea::opt_in_smem(causal_flat_kernel<D, T, STATS, BIDIR, IMPL>,
                                   bytes, opted_in);
  if (e != cudaSuccess) return e;
  dim3 grid(nh, t_dst / BQ);
  causal_flat_kernel<D, T, STATS, BIDIR, IMPL><<<grid, TPB, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint32_t*)mbits,
      (const float*)scaler, (const int*)counts, (const int*)idx,
      (const int*)tiles, (const int*)rowbase, (const int*)lengths, (T*)out,
      (float*)lse, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, sub,
      oversample, k_cfg, keep_lo, keep_hi, col_base);
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
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k) || head_dim != 64 ||
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
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(head_dim, is_bf16, [&](auto d, auto t) {
    return launch<decltype(d)::value, typename decltype(t)::type, false, false>(
        q, k, v, mbits, scaler, counts, idx, nullptr, rowbase, nullptr, out, nullptr, nh,
        t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, 0, oversample, k_cfg,
        keep_lo, keep_hi, 0, (cudaStream_t)stream);
  });
}

// The forward of the differentiable path (K2): f32 or bf16 in and out, lse
// (nh, t_dst) float32; head width 64 or 80.
extern "C" int sea_causal_fwd_stats(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* rowbase, void* out, void* lse, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, int is_bf16, void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)sea::dispatch(head_dim, is_bf16, [&](auto d, auto t) {
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
  if (bad_geometry(head_dim, n_words, t_dst, t_win, block_q, block_k) || head_dim != 64 ||
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
// (nh,) int32, the row width of each batch·head.
extern "C" int sea_bidir_forward(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* lengths, void* out, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, int is_bf16, void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k) || head_dim != 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      is_bf16 ? launch<64, __nv_bfloat16, false, true>(
                    q, k, v, mbits, scaler, counts, idx, nullptr, nullptr,
                    lengths, out, nullptr, nh, t_dst, t_src, t_m, n_words,
                    block_q, block_k, nq, nkb, 0, 1.0f, 1.0f, 1.0f, 1.0f, 0, s)
              : launch<64, float, false, true>(
                    q, k, v, mbits, scaler, counts, idx, nullptr, nullptr,
                    lengths, out, nullptr, nh, t_dst, t_src, t_m, n_words,
                    block_q, block_k, nq, nkb, 0, 1.0f, 1.0f, 1.0f, 1.0f, 0, s);
  return (int)e;
}

extern "C" int sea_alive_mask(const void* mbits, void* out, int nh, int t_dst,
                              int t_src, int t_m, int n_words, void* stream) {
  dim3 grid((t_src + 255) / 256, t_dst, nh);
  alive_mask_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mbits, nullptr, (int8_t*)out, t_dst, t_src, t_m,
      n_words);
  return (int)cudaGetLastError();
}

extern "C" int sea_bidir_alive_mask(const void* mbits, const void* lengths,
                                    void* out, int nh, int t_dst, int t_src,
                                    int t_m, int n_words, void* stream) {
  dim3 grid((t_src + 255) / 256, t_dst, nh);
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
  dim3 grid((t_src + 255) / 256, t_dst, nh);
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

// quot_check_kernel over 1 <= w <= w_max; `bad` one uint64 on the device,
// zeroed by the caller.
extern "C" int sea_quot_check(int w_max, void* bad, void* stream) {
  if (w_max <= 0 || w_max > (1 << 24)) return (int)cudaErrorInvalidValue;
  quot_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      w_max, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
