// Fused block-sparse SEA attention forward kernels for Hopper (sm_90a): the
// causal forward, its forward-with-stats variant, the padded bidirectional
// forward and the causal forward's three impl variants, instances of one
// kernel body.
//
// Replaces these TPU kernels of sea_tpu/ops/kernels/block_sparse.py:
//   * `_causal_kernel_flat` (impl "flat", the causal benchmark path), entry
//     point `sea_causal_flat_forward` (K1);
//   * `_causal_kernel_fwd_stats` (the forward of the differentiable
//     `fused_sparse_attention`), entry point `sea_causal_fwd_stats` (K2): the
//     body instantiated with STATS = true, without the undersampling
//     predicate, and writing the per-row logsumexp (+inf on rows with no
//     alive column) that the backward kernels (block_sparse_diff.cu) read;
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
// Design. One thread block of 256 threads per (batch·head, 64-row q-tile).
// It walks the q-block's list of active k-blocks (`counts`/`idx`, a
// conservative superset built on the host side) in 64-column sub-tiles,
// skips sub-tiles that lie wholly past the tile's last row (bidirectional:
// past the example's length), and for each
// sub-tile computes S = Q·Kᵀ with plain float32 FMAs (no TF32: the slice
// runs float32 and must agree with the plain version), applies the element
// predicate, and runs an online-softmax update of the row max m, the row sum
// l and the float32 accumulator acc += P·V. Blocks are independent; nothing
// carries across the grid. Thread (ty, tx) of the 16 x 16 layout owns rows
// 4·ty .. 4·ty+3 and score columns tx + 16·j; row reductions are shuffles
// inside each 16-lane half warp. Q, K, V and P live in shared memory with
// rows padded by one float so that the column walks hit distinct banks.
//
// K6 walks the same lists restricted to one window: the ring launches it S
// times per shard (S² per layer), each over a 1/S slice of the columns, so
// its bound and its design are K2's on a smaller problem.
//
// What bounds it on this card. The function itself is bound by bytes: it
// needs 4·D FLOPs per alive element only, and the main path's masks keep
// about 6-12% of the causal triangle, so reading q, k, v, the mask bits and
// the scaler once and writing out at HBM's 3.35 TB/s takes longer than the
// alive work at the FP32 FMA peak (67 TFLOP/s). This kernel is far from that
// bound because it does dense work on every visited 64 x 64 tile (4·64·64·D
// FLOPs, nearly the whole triangle on these masks) on the FMA pipes, with one
// shared-memory load per two FMAs and one IEEE division per element for the
// predicate (PERF.md; no hardware counters were read). Gathering alive
// columns, wgmma and TMA are later work.
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
//     division form stays inside it). With `exact` and one word, each thread
//     holds its rows' word in a register for the tile and looks nothing up;
//     with two, one register select per element; otherwise a lookup in the
//     q-tile's staged words, dead outside lo .. hi.
//   * K9b (WORD_LOOP) keeps no shared-memory copy of the mask words: for each
//     row, a thread walks w = lo .. hi (a dynamic trip count of at most 16),
//     reads word w through L1 once and selects it into the elements whose
//     word it is, as the TPU's fori_loop body does. Against K9a it saves the
//     staging of 64 x n_words words per block and a shared-memory lookup per
//     element, and costs one global (L1) load per word of the range, per row
//     and sub-tile, and a compare-select per element and word.
//   * K9c (SUBTILE) walks outer k-blocks (`block_k`, the JAX package's
//     auto_block width) and, inside each, visits only the `sub`-wide pieces
//     whose bit is set in the tile's `submask` (`tile_activity_sub`), skipping
//     the loads, Q·Kᵀ, the predicate and P·V of every other piece. When the
//     q-block's first row is wide enough (`sub_short`), a piece's pixels fall
//     in two words, and each thread loads the two candidates of its rows once
//     per piece (the TPU kernel's short path).
// Every variant walks the listed 64-column sub-tiles in increasing order, and
// a sub-tile with no alive element leaves m, l and acc exactly as they were
// (exp only of alive scores, corr = exp(0) = 1), so each should equal K1's
// output bit for bit on the same inputs. Their bound is K1's, by bytes; what
// they change is the predicate's cost per visited element (K9a, K9b) and the
// number of visited sub-tiles (K9c), not the bytes.
//
// The element predicates live in sea_mask.cuh (`alive_elem`, `alive_elem_len`,
// and K9a-c's `alive_elem_wr`, `alive_elem_loop`, `alive_elem_sub`), shared
// with the backward kernels and with the debug kernels `alive_mask_kernel`
// and `impl_alive_mask_kernel`, which let the card check each bit for bit
// against the oracle.

#include "sea_mask.cuh"

namespace {

using sea::alive_elem;
using sea::alive_elem_len;
using sea::bad_geometry;
using sea::bad_window;
using sea::keep_elem;
using sea::load_f;
using sea::store_f;
using sea::MAX_DEVICES;
using sea::MAX_WORDS;

constexpr int BQ = sea::TILE;   // query rows per block
constexpr int BKT = sea::TILE;  // key columns per sub-tile
constexpr int TPB = 256;     // 16 row groups x 16 column lanes
constexpr float M_INIT = -1.0e30f;  // running-max floor: exp(-inf - m) == 0

// Which mask words the causal element predicate reads: all of the row's
// (K1, K2, K5, K6), the tile's word range staged (K9a) or walked (K9b), or
// the words of the active pieces only (K9c).
enum Impl : int { FLAT = 0, WORD_RANGE = 1, WORD_LOOP = 2, SUBTILE = 3 };

template <int D>
struct Smem {
  static constexpr int DP = D + 1;
  static constexpr int Q = BQ * DP;
  // K sub-tile (BKT x DP), then the P sub-tile (BQ x BKT+1) in the same room
  static constexpr int KP = (BKT * DP > BQ * (BKT + 1)) ? BKT * DP : BQ * (BKT + 1);
  static constexpr int V = BKT * D;
  static constexpr int bytes = (Q + KP + V) * 4 + BQ * MAX_WORDS * 4;
};

// STATS: the forward of the differentiable path. The undersampling predicate
// is off and `lse` receives each row's logsumexp.
// BIDIR: the padded bidirectional forward. Row widths come from `lengths`
// (one per batch·head); `rowbase` and the undersampling predicate are unused.
// IMPL: which mask words the element predicate reads (K9a-c; FLAT for the
// others). `tiles` (batch·head, nq, nkb) lies beside `idx`: each listed
// tile's word range (WORD_RANGE, WORD_LOOP) or bitmask of active `sub`-wide
// pieces (SUBTILE); FLAT reads neither.
template <int D, typename T, bool STATS, bool BIDIR, int IMPL = FLAT>
__global__ void __launch_bounds__(TPB) causal_flat_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint32_t* __restrict__ mbits, const float* __restrict__ scaler,
    const int* __restrict__ counts, const int* __restrict__ idx,
    const int* __restrict__ tiles, const int* __restrict__ rowbase,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ lse, int t_dst, int t_src, int t_m, int n_words,
    int block_q, int block_k, int nq, int nkb, int sub, float oversample,
    float k_cfg, float keep_lo, float keep_hi, int col_base) {
  using S = Smem<D>;
  constexpr int DP = S::DP;
  constexpr int PP = BKT + 1;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KPs = Qs + S::Q;
  float* Vs = KPs + S::KP;
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Vs + S::V);

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * BQ;  // first local row of the tile
  const int qb = row0 / block_q;     // q-block of the tile lists
  const int grow0 = BIDIR ? row0 : rowbase[qb] + (row0 - qb * block_q);
  const int len = BIDIR ? lengths[bh] : 0;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const long qoff = ((long)bh * t_dst + row0) * D;
  for (int i = tid; i < BQ * D; i += TPB) Qs[(i / D) * DP + (i % D)] = load_f(q, qoff + i);
  const long moff = ((long)bh * t_dst + row0) * n_words;
  // WORD_LOOP reads its rows' words from global memory (L1) instead
  if (IMPL != WORD_LOOP)
    for (int i = tid; i < BQ * n_words; i += TPB) Ms[i] = mbits[moff + i];
  // WORD_RANGE and SUBTILE read other rows' staged words before the first
  // sub-tile's barrier
  if (IMPL == WORD_RANGE || IMPL == SUBTILE) __syncthreads();

  float m_i[4], l_i[4], acc[4][DPT], ps[4], thr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = M_INIT;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
    const float w = (float)(grow0 + ty * 4 + i + 1);
    ps[i] = fmaxf(floorf(__fadd_rn(__fdiv_rn(w, oversample), 0.5f)), 1.0f);
    const float oys = __fdiv_rn(fminf(fmaxf(w, keep_lo), keep_hi), k_cfg);
    thr[i] = __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, oys), 0.5f), 1e-4f);
  }
  const bool undersample = !STATS && !BIDIR && oversample != 1.0f;
  const float dead = __uint_as_float(0xff800000u);  // -inf

  const int cnt = counts[bh * nq + qb];
  const int* lst = idx + ((long)bh * nq + qb) * nkb;
  const int* tls = tiles + ((long)bh * nq + qb) * nkb;  // read unless FLAT
  // SUBTILE: whether this q-block's rows take the two-candidate path
  const bool shrt = IMPL == SUBTILE && sea::sub_short(grow0 - (row0 - qb * block_q), t_m, sub);
  // every column from here on is dead on every row of the tile
  const int col_end = BIDIR ? len : grow0 + BQ;
  // k and v hold the (global) columns col_base .. col_stop − 1
  const int col_stop = col_base + t_src;
  const long kvbase = ((long)bh * t_src - col_base) * D;

  for (int e = 0; e < cnt; ++e) {
    const int kb = lst[e];
    const int aux = IMPL != FLAT ? tls[e] : 0;
    // WORD_RANGE, WORD_LOOP: the tile's word range; WORD_RANGE keeps each of
    // its rows' one or two candidate words in registers for the tile.
    // SUBTILE: the rows' two candidates of the current piece.
    sea::WordRange g{0, 0, false, false};
    uint32_t cand0[4] = {0u, 0u, 0u, 0u}, cand1[4] = {0u, 0u, 0u, 0u};
    int cand_w[4] = {0, 0, 0, 0};
    if (IMPL == WORD_RANGE || IMPL == WORD_LOOP) g = sea::word_range(aux);
    if (IMPL == WORD_RANGE && (g.one || g.two)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t* words = Ms + (ty * 4 + i) * n_words;
        cand0[i] = words[g.lo];
        cand1[i] = g.two ? words[g.lo + 1] : 0u;
      }
    }
    for (int c0 = kb * block_k; c0 < (kb + 1) * block_k; c0 += BKT) {
      // wholly past the causal edge, the length or the window
      if (c0 >= col_end || c0 >= col_stop) break;
      if (IMPL == SUBTILE) {
        // skip the dead pieces whole: no loads, no Q·Kᵀ, no predicate, no P·V
        const int off = c0 - kb * block_k;
        if ((((unsigned)aux >> (off / sub)) & 1u) == 0u) continue;
        if (shrt && off % sub == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sea::sub_candidates(Ms + (ty * 4 + i) * n_words, c0, grow0 + ty * 4 + i,
                                t_m, n_words, cand_w[i], cand0[i], cand1[i]);
        }
      }
      __syncthreads();  // the previous sub-tile's P and V are consumed
      for (int i = tid; i < BKT * D; i += TPB) {
        const int c = i / D, d = i % D;
        const bool in = c0 + c < col_stop;
        KPs[c * DP + d] = in ? load_f(k, kvbase + (long)c0 * D + i) : 0.f;
        Vs[i] = in ? load_f(v, kvbase + (long)c0 * D + i) : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = KPs[(tx + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = ty * 4 + i;
        const int r = grow0 + rl;
        const uint32_t* words = Ms + rl * n_words;
        const float w = (float)(r + 1);
        float rmax = M_INIT;
        // WORD_LOOP: the words of the thread's 4 columns in one walk over
        // the range, each word read once through L1
        uint32_t lw[4] = {0u, 0u, 0u, 0u};
        int lpix[4] = {-1, -1, -1, -1};
        if (IMPL == WORD_LOOP) {
          int wi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lpix[j] = sea::causal_pixel(c0 + tx + 16 * j, r, t_m);
            wi[j] = lpix[j] >= 0 ? lpix[j] >> 5 : -1;
          }
          sea::loop_words<4>(mbits + moff + (long)rl * n_words, g.lo, g.hi, wi, lw);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          bool a;
          if (BIDIR)
            a = alive_elem_len(words, col, len, t_m);
          else if (IMPL == WORD_RANGE)
            a = sea::alive_elem_wr(words, col, r, t_m, g, cand0[i], cand1[i]);
          else if (IMPL == WORD_LOOP)
            a = lpix[j] >= 0 && sea::pixel_bit(lw[j], lpix[j]);
          else if (IMPL == SUBTILE)
            a = sea::alive_elem_sub(words, col, r, t_m, shrt, cand_w[i], cand0[i],
                                    cand1[i]);
          else
            a = alive_elem(words, col, r, t_m);
          if (undersample) a = a && keep_elem(col, w, ps[i], thr[i]);
          s[i][j] = a ? s[i][j] : dead;
          rmax = fmaxf(rmax, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
        const float m_new = fmaxf(m_i[i], rmax);
        const float corr = expf(m_i[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);  // dead lanes: exp(-inf) == 0
          psum += s[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l_i[i] = l_i[i] * corr + psum;
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= corr;
        m_i[i] = m_new;
      }

      __syncthreads();  // every thread is done reading K
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) KPs[(ty * 4 + i) * PP + tx + 16 * j] = s[i][j];
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < BKT; ++c) {
        float pv[4], vv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = KPs[(ty * 4 + i) * PP + c];
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) vv[jj] = Vs[c * D + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty * 4 + i;
    const float l = l_i[i];
    const float safe_l = l > 0.f ? l : 1.f;
    const float sc = scaler ? scaler[(long)bh * t_dst + row0 + rl] : 1.f;
    const long o = qoff + (long)rl * D;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      store_f(out, o + tx + 16 * jj, acc[i][jj] / safe_l * sc);
    // logsumexp; +inf for rows with no alive column, so that the backward's
    // exp(s - lse) is 0 there (m and l are equal across the 16 lanes)
    if (STATS && tx == 0)
      lse[(long)bh * t_dst + row0 + rl] =
          l > 0.f ? m_i[i] + logf(l) : __uint_as_float(0x7f800000u);
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

template <int D, typename T, bool STATS, bool BIDIR, int IMPL = FLAT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mbits, const void* scaler, const void* counts,
                   const void* idx, const void* tiles, const void* rowbase,
                   const void* lengths, void* out, void* lse, int nh,
                   int t_dst, int t_src, int t_m, int n_words, int block_q,
                   int block_k, int nq, int nkb, int sub, float oversample,
                   float k_cfg, float keep_lo, float keep_hi, int col_base,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<D>::bytes;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  cudaError_t e = sea::opt_in_smem(causal_flat_kernel<D, T, STATS, BIDIR, IMPL>,
                                   bytes, opted_in);
  if (e != cudaSuccess) return e;
  dim3 grid(t_dst / BQ, nh);
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
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k) ||
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
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      is_bf16 ? launch<64, __nv_bfloat16, false, false>(
                    q, k, v, mbits, scaler, counts, idx, nullptr, rowbase,
                    nullptr, out, nullptr, nh, t_dst, t_src, t_m, n_words,
                    block_q, block_k, nq, nkb, 0, oversample, k_cfg, keep_lo,
                    keep_hi, 0, s)
              : launch<64, float, false, false>(
                    q, k, v, mbits, scaler, counts, idx, nullptr, rowbase,
                    nullptr, out, nullptr, nh, t_dst, t_src, t_m, n_words,
                    block_q, block_k, nq, nkb, 0, oversample, k_cfg, keep_lo,
                    keep_hi, 0, s);
  return (int)e;
}

// The forward of the differentiable path: float32 in and out, lse (nh, t_dst)
// float32.
extern "C" int sea_causal_fwd_stats(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* rowbase, void* out, void* lse, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)launch<64, float, true, false>(
      q, k, v, mbits, scaler, counts, idx, nullptr, rowbase, nullptr, out, lse,
      nh, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb, 0, 1.0f,
      1.0f, 1.0f, 1.0f, 0, (cudaStream_t)stream);
}

// K6, the forward with stats over one K/V window (float32): k and v are
// (nh, t_win, D) and hold the global columns col_base .. col_base + t_win − 1;
// idx (nh, nq, nkw) carries global k-block ids of that window; the scaler is
// one; out (nh, t_dst, D) is the window-normalised output and lse (nh, t_dst)
// the window's logsumexp, +inf on rows with nothing alive in it.
extern "C" int sea_window_fwd_stats(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* counts, const void* idx, const void* rowbase, void* out,
    void* lse, int nh, int t_dst, int t_win, int head_dim, int t_m,
    int n_words, int block_q, int block_k, int nq, int nkw, int col_base,
    void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_win, block_q, block_k) ||
      bad_window(col_base, block_k))
    return (int)cudaErrorInvalidValue;
  return (int)launch<64, float, true, false>(
      q, k, v, mbits, nullptr, counts, idx, nullptr, rowbase, nullptr, out,
      lse, nh, t_dst, t_win, t_m, n_words, block_q, block_k, nq, nkw, 0, 1.0f,
      1.0f, 1.0f, 1.0f, col_base, (cudaStream_t)stream);
}

// The padded bidirectional forward (K5): f32 or bf16 in and out, `lengths`
// (nh,) int32, the row width of each batch·head.
extern "C" int sea_bidir_forward(
    const void* q, const void* k, const void* v, const void* mbits,
    const void* scaler, const void* counts, const void* idx,
    const void* lengths, void* out, int nh, int t_dst, int t_src,
    int head_dim, int t_m, int n_words, int block_q, int block_k, int nq,
    int nkb, int is_bf16, void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
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
