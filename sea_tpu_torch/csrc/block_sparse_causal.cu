// Causal fused block-sparse SEA attention for Hopper (sm_90a): the forward
// kernel and its forward-with-stats variant.
//
// Replaces two TPU kernels of sea_tpu/ops/kernels/block_sparse.py:
//   * `_causal_kernel_flat` (impl "flat", the benchmark path), entry point
//     `sea_causal_flat_forward`;
//   * `_causal_kernel_fwd_stats` (the forward of the differentiable
//     `fused_sparse_attention`), entry point `sea_causal_fwd_stats`: the same
//     kernel body instantiated with STATS = true, without the undersampling
//     predicate, and writing the per-row logsumexp (+inf on rows with no
//     alive column) that the backward kernels (block_sparse_diff.cu) read.
// For every (batch·head, query row r) it computes
//
//     out[r] = scaler[r] · softmax over alive s of (q_r · k_s) · v_s
//
// where column s is alive iff s <= r and the packed compressed mask of row r
// has bit pixel(r, s) = floor((s + 0.5) / (r + 1) · T_M − 1e-4). Rows with no
// alive column give 0. Optionally the train path's undersampling
// keep-predicate (oversample != 1) applies too, and `rowbase` shifts each
// q-block's rows to global positions.
//
// Design. One thread block of 256 threads per (batch·head, 64-row q-tile).
// It walks the q-block's list of active k-blocks (`counts`/`idx`, a
// conservative superset built on the host side) in 64-column sub-tiles,
// skips sub-tiles that lie wholly past the tile's last row, and for each
// sub-tile computes S = Q·Kᵀ with plain float32 FMAs (no TF32: the slice
// runs float32 and must agree with the plain version), applies the element
// predicate, and runs an online-softmax update of the row max m, the row sum
// l and the float32 accumulator acc += P·V. Blocks are independent; nothing
// carries across the grid. Thread (ty, tx) of the 16 x 16 layout owns rows
// 4·ty .. 4·ty+3 and score columns tx + 16·j; row reductions are shuffles
// inside each 16-lane half warp. Q, K, V and P live in shared memory with
// rows padded by one float so that the column walks hit distinct banks.
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
// The element predicate lives in sea_mask.cuh (`alive_elem`), shared with the
// backward kernels and with the debug kernel `alive_mask_kernel`, which lets
// the card check it bit for bit against the oracle.

#include "sea_mask.cuh"

namespace {

using sea::alive_elem;
using sea::bad_geometry;
using sea::keep_elem;
using sea::load_f;
using sea::store_f;
using sea::MAX_DEVICES;
using sea::MAX_WORDS;

constexpr int BQ = sea::TILE;   // query rows per block
constexpr int BKT = sea::TILE;  // key columns per sub-tile
constexpr int TPB = 256;     // 16 row groups x 16 column lanes
constexpr float M_INIT = -1.0e30f;  // running-max floor: exp(-inf - m) == 0

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
template <int D, typename T, bool STATS>
__global__ void __launch_bounds__(TPB) causal_flat_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint32_t* __restrict__ mbits, const float* __restrict__ scaler,
    const int* __restrict__ counts, const int* __restrict__ idx,
    const int* __restrict__ rowbase, T* __restrict__ out,
    float* __restrict__ lse, int t_dst, int t_src, int t_m, int n_words,
    int block_q, int block_k, int nq, int nkb, float oversample, float k_cfg,
    float keep_lo, float keep_hi) {
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
  const int grow0 = rowbase[qb] + (row0 - qb * block_q);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const long qoff = ((long)bh * t_dst + row0) * D;
  for (int i = tid; i < BQ * D; i += TPB) Qs[(i / D) * DP + (i % D)] = load_f(q, qoff + i);
  const long moff = ((long)bh * t_dst + row0) * n_words;
  for (int i = tid; i < BQ * n_words; i += TPB) Ms[i] = mbits[moff + i];

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
  const bool undersample = !STATS && oversample != 1.0f;
  const float dead = __uint_as_float(0xff800000u);  // -inf

  const int cnt = counts[bh * nq + qb];
  const int* lst = idx + ((long)bh * nq + qb) * nkb;
  const int last_row = grow0 + BQ - 1;
  const long kvbase = (long)bh * t_src * D;

  for (int e = 0; e < cnt; ++e) {
    const int kb = lst[e];
    for (int c0 = kb * block_k; c0 < (kb + 1) * block_k; c0 += BKT) {
      if (c0 > last_row || c0 >= t_src) break;  // wholly past the causal edge
      __syncthreads();  // the previous sub-tile's P and V are consumed
      for (int i = tid; i < BKT * D; i += TPB) {
        const int c = i / D, d = i % D;
        const bool in = c0 + c < t_src;
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
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          bool a = alive_elem(words, col, r, t_m);
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
    const float sc = scaler[(long)bh * t_dst + row0 + rl];
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

__global__ void alive_mask_kernel(const uint32_t* __restrict__ mbits,
                                  int8_t* __restrict__ out, int t_dst,
                                  int t_src, int t_m, int n_words) {
  const int bh = blockIdx.z, r = blockIdx.y;
  const uint32_t* words = mbits + ((long)bh * t_dst + r) * n_words;
  int8_t* row = out + ((long)bh * t_dst + r) * t_src;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < t_src;
       s += gridDim.x * blockDim.x)
    row[s] = alive_elem(words, s, r, t_m) ? 1 : 0;
}

template <int D, typename T, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mbits, const void* scaler, const void* counts,
                   const void* idx, const void* rowbase, void* out, void* lse,
                   int nh, int t_dst, int t_src, int t_m, int n_words,
                   int block_q, int block_k, int nq, int nkb, float oversample,
                   float k_cfg, float keep_lo, float keep_hi,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<D>::bytes;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  cudaError_t e =
      sea::opt_in_smem(causal_flat_kernel<D, T, STATS>, bytes, opted_in);
  if (e != cudaSuccess) return e;
  dim3 grid(t_dst / BQ, nh);
  causal_flat_kernel<D, T, STATS><<<grid, TPB, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint32_t*)mbits,
      (const float*)scaler, (const int*)counts, (const int*)idx,
      (const int*)rowbase, (T*)out, (float*)lse, t_dst, t_src, t_m, n_words,
      block_q, block_k, nq, nkb, oversample, k_cfg, keep_lo, keep_hi);
  return cudaGetLastError();
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
      is_bf16 ? launch<64, __nv_bfloat16, false>(
                    q, k, v, mbits, scaler, counts, idx, rowbase, out, nullptr,
                    nh, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb,
                    oversample, k_cfg, keep_lo, keep_hi, s)
              : launch<64, float, false>(
                    q, k, v, mbits, scaler, counts, idx, rowbase, out, nullptr,
                    nh, t_dst, t_src, t_m, n_words, block_q, block_k, nq, nkb,
                    oversample, k_cfg, keep_lo, keep_hi, s);
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
  return (int)launch<64, float, true>(
      q, k, v, mbits, scaler, counts, idx, rowbase, out, lse, nh, t_dst, t_src,
      t_m, n_words, block_q, block_k, nq, nkb, 1.0f, 1.0f, 1.0f, 1.0f,
      (cudaStream_t)stream);
}

extern "C" int sea_alive_mask(const void* mbits, void* out, int nh, int t_dst,
                              int t_src, int t_m, int n_words, void* stream) {
  dim3 grid((t_src + 255) / 256, t_dst, nh);
  alive_mask_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mbits, (int8_t*)out, t_dst, t_src, t_m, n_words);
  return (int)cudaGetLastError();
}
