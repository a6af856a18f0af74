// Backward kernels of the differentiable causal fused sparse attention for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of sea_tpu/ops/kernels/block_sparse.py, the
// backward of `fused_sparse_attention` (`_fused_bwd`):
//   * `_causal_kernel_dq`, entry point `sea_causal_dq`:
//         dq[r] = Σ_s ds[r, s] · k[s];
//   * `_causal_kernel_dkv`, entry point `sea_causal_dkv`:
//         dk[s] = Σ_r ds[r, s] · q[r],   dv[s] = Σ_r p[r, s] · dou[r];
// with the flash-style recompute, over the alive elements only:
//         p  = exp(q_r · k_s − lse[r])   (0 off the element mask),
//         dp = dou_r · v_s,
//         ds = p · (dp − delta[r]).
// `lse` comes from the forward-with-stats kernel (+inf on rows with no alive
// column, where p is then 0), `dou` = dO · scaler and `delta` = Σ_d dou · o /
// scaler are computed outside the kernels in plain PyTorch, as the JAX
// package does. The element mask is sea_mask.cuh's `alive_elem`, the one the
// forward kernels use, so all three kernels agree on it bit for bit.
//
// Design. Both kernels use the forward kernel's layout: 256 threads as a
// 16 x 16 grid, thread (ty, tx) owning 4 rows x 4 columns of each 64 x 64
// score tile (rows 4·ty + i, columns tx + 16·j) and 4 rows x D/16 columns of
// its output (columns tx + 16·jj); plain float32 FMAs (no TF32); tiles in
// shared memory with rows padded by one float. Neither kernel uses atomics,
// so the gradients are the same from run to run.
//   * dq: one block per (batch·head, 64-row q-tile). Q, dO, the rows' mask
//     words, lse and delta stay in shared memory; the block walks its
//     q-block's list of active k-blocks (`counts`/`idx`) in 64-column
//     sub-tiles, stopping at the causal edge, recomputes S and dP in one pass
//     over d, forms dS in shared memory and accumulates dq += dS · K in
//     registers.
//   * dk/dv: one block per (batch·head, 64-column k-tile). K and V stay in
//     shared memory; the block walks the TRANSPOSED lists (`counts_t`/`idx_t`:
//     the q-blocks with an alive element in its k-block) in 64-row
//     sub-tiles, skipping sub-tiles that end before the k-tile's first
//     column, recomputes Sᵀ and dPᵀ, forms Pᵀ and dSᵀ in shared memory and
//     accumulates dv += Pᵀ · dO and dk += dSᵀ · Q in registers.
//
// What bounds them on this card. As functions they are bound by bytes: per
// alive element dq needs 6·D FLOPs and dk/dv 8·D, and at the main path's
// densities (6-12% of the causal triangle) reading q, k, v, dO, the mask
// bits, lse and delta once and writing the gradients at 3.35 TB/s takes
// longer than that work at the FP32 FMA peak (67 TFLOP/s). Like the forward
// kernel they are far from it: they do dense work on every visited 64 x 64
// tile on the FMA pipes, with one shared-memory load per two FMAs and one
// IEEE division per element for the predicate. dk/dv holds six 64 x 65
// float tiles (about 104 KB), so it needs the dynamic shared-memory opt-in
// and fits two blocks per SM. wgmma, TMA and gathering alive columns are
// later work.

#include "sea_mask.cuh"

namespace {

using sea::alive_elem;
using sea::bad_geometry;
using sea::MAX_DEVICES;
using sea::MAX_WORDS;

constexpr int BQ = sea::TILE;   // query rows per tile
constexpr int BKT = sea::TILE;  // key columns per tile
constexpr int TPB = 256;  // 16 row groups x 16 column lanes

template <int D>
struct Tiles {
  static constexpr int DP = D + 1;   // padded row of a D-wide tile
  static constexpr int PP = BKT + 1; // padded row of a score tile
  static_assert(BQ == BKT, "square score tiles");
};

// dq: Q, dO (BQ x DP), K, V (BKT x DP), dS (BQ x PP), words, lse, delta.
template <int D>
constexpr int dq_smem_bytes() {
  return (2 * BQ * Tiles<D>::DP + 2 * BKT * Tiles<D>::DP + BQ * Tiles<D>::PP +
          2 * BQ) * 4 + BQ * MAX_WORDS * 4;
}

// dk/dv: K, V (BKT x DP), Q, dO (BQ x DP), Pᵀ, dSᵀ (BKT x PP), words, lse,
// delta.
template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BKT * Tiles<D>::DP + 2 * BQ * Tiles<D>::DP +
          2 * BKT * Tiles<D>::PP + 2 * BQ) * 4 + BQ * MAX_WORDS * 4;
}

template <int D>
__global__ void __launch_bounds__(TPB) causal_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint32_t* __restrict__ mbits,
    const float* __restrict__ dou, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts,
    const int* __restrict__ idx, const int* __restrict__ rowbase,
    float* __restrict__ dq, int t_dst, int t_src, int t_m, int n_words,
    int block_q, int block_k, int nq, int nkb) {
  constexpr int DP = Tiles<D>::DP, PP = Tiles<D>::PP, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + BQ * DP;
  float* Ks = Os + BQ * DP;
  float* Vs = Ks + BKT * DP;
  float* dSs = Vs + BKT * DP;
  float* Ls = dSs + BQ * PP;
  float* Dl = Ls + BQ;
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Dl + BQ);

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int qb = row0 / block_q;
  const int grow0 = rowbase[qb] + (row0 - qb * block_q);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const long qoff = ((long)bh * t_dst + row0) * D;
  for (int i = tid; i < BQ * D; i += TPB) {
    const int r = i / D, d = i % D;
    Qs[r * DP + d] = q[qoff + i];
    Os[r * DP + d] = dou[qoff + i];
  }
  const long moff = ((long)bh * t_dst + row0) * n_words;
  for (int i = tid; i < BQ * n_words; i += TPB) Ms[i] = mbits[moff + i];
  for (int i = tid; i < BQ; i += TPB) {
    Ls[i] = lse[(long)bh * t_dst + row0 + i];
    Dl[i] = delta[(long)bh * t_dst + row0 + i];
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;

  const int cnt = counts[bh * nq + qb];
  const int* lst = idx + ((long)bh * nq + qb) * nkb;
  const int last_row = grow0 + BQ - 1;
  const long kvbase = (long)bh * t_src * D;

  for (int e = 0; e < cnt; ++e) {
    const int kb = lst[e];
    for (int c0 = kb * block_k; c0 < (kb + 1) * block_k; c0 += BKT) {
      if (c0 > last_row || c0 >= t_src) break;  // wholly past the causal edge
      __syncthreads();  // the previous sub-tile's dS and K are consumed
      for (int i = tid; i < BKT * D; i += TPB) {
        const int c = i / D, d = i % D;
        const bool in = c0 + c < t_src;
        Ks[c * DP + d] = in ? k[kvbase + (long)c0 * D + i] : 0.f;
        Vs[c * DP + d] = in ? v[kvbase + (long)c0 * D + i] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty * 4 + i) * DP + d];
          ov[i] = Os[(ty * 4 + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = Ks[(tx + 16 * j) * DP + d];
          vv[j] = Vs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = ty * 4 + i;
        const int r = grow0 + rl;
        const uint32_t* words = Ms + rl * n_words;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          // off the mask p is 0 without evaluating exp, so an empty row's
          // lse = +inf never meets a score
          const float p = alive_elem(words, col, r, t_m) ? expf(s[i][j] - Ls[rl]) : 0.f;
          dSs[rl * PP + tx + 16 * j] = p * (dp[i][j] - Dl[rl]);
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < BKT; ++c) {
        float dsv[4], kv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * PP + c];
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) kv[jj] = Ks[c * DP + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = fmaf(dsv[i], kv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long o = qoff + (long)(ty * 4 + i) * D;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) dq[o + tx + 16 * jj] = acc[i][jj];
  }
}

template <int D>
__global__ void __launch_bounds__(TPB) causal_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint32_t* __restrict__ mbits,
    const float* __restrict__ dou, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ counts_t,
    const int* __restrict__ idx_t, const int* __restrict__ rowbase,
    float* __restrict__ dk, float* __restrict__ dv, int t_dst, int t_src,
    int t_m, int n_words, int block_q, int block_k, int nq, int nkb) {
  constexpr int DP = Tiles<D>::DP, PP = Tiles<D>::PP, DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKT * DP;
  float* Qs = Vs + BKT * DP;
  float* Os = Qs + BQ * DP;
  float* Pt = Os + BQ * DP;
  float* dSt = Pt + BKT * PP;
  float* Ls = dSt + BKT * PP;
  float* Dl = Ls + BQ;
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Dl + BQ);

  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * BKT;  // first column of the k-tile
  const int kb = col0 / block_k;      // k-block of the transposed lists
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const long koff = ((long)bh * t_src + col0) * D;
  for (int i = tid; i < BKT * D; i += TPB) {
    const int c = i / D, d = i % D;
    Ks[c * DP + d] = k[koff + i];
    Vs[c * DP + d] = v[koff + i];
  }

  // thread (ty, tx): k-tile rows ty·4 + i, output columns tx + 16·jj
  float acc_k[4][DPT], acc_v[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  const int cnt = counts_t[bh * nkb + kb];
  const int* lst = idx_t + ((long)bh * nkb + kb) * nq;
  const long rbase = (long)bh * t_dst;

  for (int e = 0; e < cnt; ++e) {
    const int qb = lst[e];
    for (int r0 = qb * block_q; r0 < (qb + 1) * block_q; r0 += BQ) {
      if (r0 >= t_dst) break;
      const int grow0 = rowbase[qb] + (r0 - qb * block_q);
      if (grow0 + BQ - 1 < col0) continue;  // every row ends before the tile
      __syncthreads();  // the previous sub-tile's Pᵀ, dSᵀ, Q and dO are consumed
      for (int i = tid; i < BQ * D; i += TPB) {
        const int r = i / D, d = i % D;
        Qs[r * DP + d] = q[(rbase + r0) * D + i];
        Os[r * DP + d] = dou[(rbase + r0) * D + i];
      }
      for (int i = tid; i < BQ * n_words; i += TPB)
        Ms[i] = mbits[(rbase + r0) * n_words + i];
      for (int i = tid; i < BQ; i += TPB) {
        Ls[i] = lse[rbase + r0 + i];
        Dl[i] = delta[rbase + r0 + i];
      }
      __syncthreads();

      // sᵀ[i][j] = k_c · q_r and dpᵀ[i][j] = v_c · dou_r for the k-tile row
      // c = ty·4 + i and the sub-tile row r = tx + 16·j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * DP + d];
          vv[i] = Vs[(ty * 4 + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          ov[j] = Os[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cl = ty * 4 + i;
        const int col = col0 + cl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = tx + 16 * j;
          const float p = alive_elem(Ms + rl * n_words, col, grow0 + rl, t_m)
                              ? expf(s[i][j] - Ls[rl]) : 0.f;
          Pt[cl * PP + rl] = p;
          dSt[cl * PP + rl] = p * (dp[i][j] - Dl[rl]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4], ov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty * 4 + i) * PP + r];
          dsv[i] = dSt[(ty * 4 + i) * PP + r];
        }
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) {
          ov[jj] = Os[r * DP + tx + 16 * jj];
          qv[jj] = Qs[r * DP + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DPT; ++jj) {
            acc_v[i][jj] = fmaf(pv[i], ov[jj], acc_v[i][jj]);
            acc_k[i][jj] = fmaf(dsv[i], qv[jj], acc_k[i][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long o = koff + (long)(ty * 4 + i) * D;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      dk[o + tx + 16 * jj] = acc_k[i][jj];
      dv[o + tx + 16 * jj] = acc_v[i][jj];
    }
  }
}

}  // namespace

extern "C" int sea_causal_dq(const void* q, const void* k, const void* v,
                             const void* mbits, const void* dou,
                             const void* lse, const void* delta,
                             const void* counts, const void* idx,
                             const void* rowbase, void* dq, int nh, int t_dst,
                             int t_src, int head_dim, int t_m, int n_words,
                             int block_q, int block_k, int nq, int nkb,
                             void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = dq_smem_bytes<64>();
  static std::atomic<bool> opted_in[MAX_DEVICES];
  cudaError_t e = sea::opt_in_smem(causal_dq_kernel<64>, bytes, opted_in);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(t_dst / BQ, nh);
  causal_dq_kernel<64><<<grid, TPB, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint32_t*)mbits, (const float*)dou, (const float*)lse,
      (const float*)delta, (const int*)counts, (const int*)idx,
      (const int*)rowbase, (float*)dq, t_dst, t_src, t_m, n_words, block_q,
      block_k, nq, nkb);
  return (int)cudaGetLastError();
}

extern "C" int sea_causal_dkv(const void* q, const void* k, const void* v,
                              const void* mbits, const void* dou,
                              const void* lse, const void* delta,
                              const void* counts_t, const void* idx_t,
                              const void* rowbase, void* dk, void* dv, int nh,
                              int t_dst, int t_src, int head_dim, int t_m,
                              int n_words, int block_q, int block_k, int nq,
                              int nkb, void* stream) {
  if (bad_geometry(head_dim, n_words, t_dst, t_src, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = dkv_smem_bytes<64>();
  static std::atomic<bool> opted_in[MAX_DEVICES];
  cudaError_t e = sea::opt_in_smem(causal_dkv_kernel<64>, bytes, opted_in);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(t_src / BKT, nh);
  causal_dkv_kernel<64><<<grid, TPB, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint32_t*)mbits, (const float*)dou, (const float*)lse,
      (const float*)delta, (const int*)counts_t, (const int*)idx_t,
      (const int*)rowbase, (float*)dk, (float*)dv, t_dst, t_src, t_m, n_words,
      block_q, block_k, nq, nkb);
  return (int)cudaGetLastError();
}
