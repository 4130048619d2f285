// The legacy three-kernel MoE backward for Hopper (sm_90a), behind
// MOEGAN_PALLAS_MOE_BWD=3.
//
// Replaces the TPU kernels moegan_tpu/ops/fused_moe.py::_bwd_dx_kernel,
// ::_bwd_dw2_kernel and ::_bwd_dw1_kernel (launched by _fused_moe_bwd_pallas).
// The default backward (fused_moe_bwd.cu) does not use this file: its
// WMMA helpers, router and weight-gradient product serve these three entry
// points alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_E = 16;
constexpr size_t SMEM_LIMIT = 232448 - 1024;
constexpr int WT = 64;   // weight-gradient output tile (rows and columns)
constexpr int WKT = 32;  // tokens per weight-gradient step

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ inline void zero16(void* dst) { *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0); }

// Cm[M, N] (+)= A[M, K] @ B[K, N] on shared-memory operands: bf16 A and B,
// each row- or column-major, fp32 row-major Cm; one 16x16 output tile per
// warp at a time. M, N, K multiples of 16.
template <typename LayoutA, typename LayoutB>
__device__ void mma_tiles(const bf16* A, int lda, const bf16* B, int ldb, float* Cm, int ldc,
                          int M, int N, int K, bool accumulate) {
  constexpr bool a_row = std::is_same<LayoutA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LayoutB, wmma::row_major>::value;
  const int warp = threadIdx.x / 32, nt = N / 16;
  for (int id = warp; id < (M / 16) * nt; id += NWARPS) {
    const int mi = id / nt, ni = id % nt;
    float* dst = Cm + mi * 16 * ldc + ni * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) {
      wmma::load_matrix_sync(acc, dst, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.f);
    }
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb;
      wmma::load_matrix_sync(fa, a_row ? A + mi * 16 * lda + kk * 16 : A + kk * 16 * lda + mi * 16, lda);
      wmma::load_matrix_sync(fb, b_row ? B + kk * 16 * ldb + ni * 16 : B + ni * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dst, acc, ldc, wmma::mem_row_major);
  }
}

// Stage columns [j0, j0 + FC) of a row-major [rows, ld] bf16 matrix into a
// [rows, FC] shared tile with row stride ldd; columns at or past `ncols`
// are zero.
__device__ inline void stage_cols(bf16* dst, int ldd, const bf16* src, int rows, int ld, int j0,
                                  int FC, int ncols) {
  const int fc8 = FC / 8;
  for (int i = threadIdx.x; i < rows * fc8; i += NTHREADS) {
    const int r = i / fc8, j = (i % fc8) * 8;
    if (j0 + j < ncols) {
      cp_async16(dst + r * ldd + j, src + (long long)r * ld + j0 + j);
    } else {
      zero16(dst + r * ldd + j);
    }
  }
}

// Stage `rows` full rows of a row-major [*, C] bf16 matrix (zero past `valid`).
__device__ inline void stage_rows(bf16* dst, int ldd, const bf16* src, int rows, int valid, int C) {
  const int c8 = C / 8;
  for (int i = threadIdx.x; i < rows * c8; i += NTHREADS) {
    const int r = i / c8, c = (i % c8) * 8;
    if (r < valid) {
      cp_async16(dst + r * ldd + c, src + (long long)r * C + c);
    } else {
      zero16(dst + r * ldd + c);
    }
  }
}
// Soft routing probabilities of a token tile, as the forward computes them.
// sP [BT, E] holds zeros on entry and p on exit (rows past `rows` see zero
// tokens and no text logits). The router logits (x @ fw) @ cw_f go FC hidden
// columns at a time through sW [C, FC] and sZ [BT, FC] (row strides ldw,
// ldz). Every thread of the block calls it; it ends in a barrier.
__device__ void router_tile(const bf16* sX, int ldx, const bf16* __restrict__ fw,
                            const float* __restrict__ cw, const float* __restrict__ tl,
                            const float* __restrict__ inv_temp, bf16* sW, int ldw, float* sZ,
                            int ldz, float* sP, int t0, int rows, int BT, int C, int Hd, int E,
                            int FC) {
  const int tid = threadIdx.x;
  // Router logits (x @ fw) @ cw_f, FC hidden columns at a time, as the forward.
  for (int j0 = 0; j0 < Hd; j0 += FC) {
    stage_cols(sW, ldw, fw, C, Hd, j0, FC, Hd);
    cp_async_wait_all();
    __syncthreads();
    mma_tiles<wmma::row_major, wmma::row_major>(sX, ldx, sW, ldw, sZ, ldz, BT, FC, C, false);
    __syncthreads();
    for (int i = tid; i < BT * E; i += NTHREADS) {
      const int r = i / E, e = i % E;
      float s = 0.f;
      for (int jj = 0; jj < FC && j0 + jj < Hd; ++jj) s = fmaf(sZ[r * ldz + jj], cw[(j0 + jj) * E + e], s);
      sP[i] += s;
    }
    __syncthreads();
  }

  // Soft routing probabilities, one thread per token.
  for (int r = tid; r < BT; r += NTHREADS) {
    const float it = inv_temp[0];
    float p[MAX_E];
    float mx = -INFINITY;
    for (int e = 0; e < E; ++e) {
      const float lg = (sP[r * E + e] + (r < rows ? tl[(long long)(t0 + r) * E + e] : 0.f)) * it;
      p[e] = fminf(fmaxf(lg, -20.f), 20.f);
      mx = fmaxf(mx, p[e]);
    }
    float sum = 0.f;
    for (int e = 0; e < E; ++e) {
      p[e] = expf(p[e] - mx);
      sum += p[e];
    }
    float sum2 = 0.f;
    for (int e = 0; e < E; ++e) {
      p[e] = fminf(fmaxf(p[e] / sum, 1e-6f), 1.f);
      sum2 += p[e];
    }
    for (int e = 0; e < E; ++e) sP[r * E + e] = p[e] / sum2;
  }
  __syncthreads();
}

// out[s][M, N] = A[t-range s]^T B[t-range s] for bf16 row-major A [T, M] and
// B [T, N] with row strides lda >= M and ldb >= N (a column slice of a wider
// matrix): block (n-tile, m-tile, s) owns a 64x64 output tile and the s-th
// range of `tchunk` tokens. Each of the 8 warps keeps two 16x16 fp32
// accumulators in registers. M and N must be multiples of 16; tiles
// overhanging M or N are zero-filled and not stored.
__global__ void __launch_bounds__(NTHREADS)
moe_wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out,
                 int T, int M, int N, int lda, int ldb, int tchunk) {
  constexpr int LDS = WT + 8;
  __shared__ __align__(128) bf16 sA[WKT * LDS];
  __shared__ __align__(128) bf16 sB[WKT * LDS];
  const int n0 = blockIdx.x * WT, m0 = blockIdx.y * WT, s = blockIdx.z;
  const int tb = s * tchunk, te = min(T, tb + tchunk);
  const int warp = threadIdx.x / 32;
  // Warp w owns output tiles (mi, ni) = (w / 2, 2 * (w % 2) + {0, 1}).
  const int mi = warp / 2, ni0 = 2 * (warp % 2);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int t = tb; t < te; t += WKT) {
    for (int i = threadIdx.x; i < 2 * WKT * (WT / 8); i += NTHREADS) {
      const bool is_b = i >= WKT * (WT / 8);
      const int k = is_b ? i - WKT * (WT / 8) : i;
      const int r = k / (WT / 8), c = (k % (WT / 8)) * 8;
      const int lim = is_b ? N : M;
      const int col = (is_b ? n0 : m0) + c;
      bf16* dst = (is_b ? sB : sA) + r * LDS + c;
      if (t + r < te && col < lim) {
        cp_async16(dst, (is_b ? B : A) + (long long)(t + r) * (is_b ? ldb : lda) + col);
      } else {
        zero16(dst);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < WKT / 16; ++kk) {
      // A^T tile: element (m, t) at sA[t * LDS + m], column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, sA + kk * 16 * LDS + mi * 16, LDS);
      for (int q = 0; q < 2; ++q) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + kk * 16 * LDS + (ni0 + q) * 16, LDS);
        wmma::mma_sync(acc[q], fa, fb, acc[q]);
      }
    }
    __syncthreads();
  }
  const int m = m0 + mi * 16;
  for (int q = 0; q < 2; ++q) {
    const int n = n0 + (ni0 + q) * 16;
    if (m < M && n < N)
      wmma::store_matrix_sync(out + ((long long)s * M + m) * N + n, acc[q], N,
                              wmma::mem_row_major);
  }
}

// out[i] = sum_k ws[k][i] for k < splits, in order.
__global__ void moe_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                               long long n, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    out[i] = s;
  }
}

int grid_for(long long n) {
  const long long b = (n + 255) / 256;
  return static_cast<int>(b < 65535 ? (b > 0 ? b : 1) : 65535);
}

// Splits of the T reduction for an [M, N] weight gradient: enough blocks for
// about two per SM, each with at least 512 tokens.
int wgrad_splits(int T, int M, int N, int sms) {
  const int tiles = ((M + WT - 1) / WT) * ((N + WT - 1) / WT);
  int s = (2 * sms + tiles - 1) / tiles;
  const int most = (T + 511) / 512;
  if (s > most) s = most;
  if (s > 65535) s = 65535;
  return s < 1 ? 1 : s;
}

int wgrad_chunk(int T, int splits) {
  const int c = (T + splits - 1) / splits;
  return (c + WKT - 1) / WKT * WKT;
}

}  // namespace

// --- The three entry points ----------------------------------------------------------------
//
// Each is an entry
// point of its own, reading no other's scratch, and each recomputes for its
// token tile the soft routing p, z = x W1_e + b1_e and h = bf16(gelu_erf(z)),
// as the TPU kernels do. They round where the TPU kernels round:
// dy_e = bf16(p_e dout) feeds dh = dy_e W2_e^T and dW2_e = h^T dy_e, and
// dz = dh gelu'(z) is rounded to bf16 before dz W1_e^T and x^T dz; the bias
// gradients are fp32 sums. (The default backward, fused_moe_bwd.cu, rounds p h
// instead, so the two backwards differ by bf16 rounding.)
//
//   moegan_moe_bwd_dx:  dx_ffn = sum_e bf16(dz_e) W1_e^T,
//                       dp[t, e] = <dout_t, h_e W2_e + b2_e>
//   moegan_moe_bwd_dw2: dW2_e = h_e^T dy_e,     db2_e = sum_t p_e dout
//   moegan_moe_bwd_dw1: dW1_e = x^T bf16(dz_e), db1_e = sum_t dz_e
//
// One token kernel, instantiated per entry point (kMode), walks its tile's
// share of the (expert, F-chunk) loop. For dx it
// keeps a [BT, C] fp32 accumulator and writes per-split partials of dx and of
// dp (computed as sum_f g h with g = dout W2^T, plus dout . b2 in split 0),
// which moe_sum_kernel adds in order. For the weight gradients it writes
// bf16 scratches (h [T, E*F] and dy [T, E*C] for dW2, dz [T, E*F] for dW1)
// and per-tile fp32 column sums for the biases; moe_wgrad_kernel then forms
// x^T dz stacked over the experts, and h_e^T dy_e once per expert (dy_e
// differs per expert), and moe_sum_kernel adds the tile partials in order.
// No atomics: two calls give the same bits.
//
// What bounds them: the products, 8 (dx: z, g, dh, dz W1^T), 4 (dw2: z,
// h^T dy) and 6 (dw1: z, dh, x^T dz) x T*C*F*E FLOPs at the bf16 tensor-
// core rate: 1.8x the fused backward's 10, by the TPU design. Each weight
// slice is staged synchronously and every WMMA product goes through shared
// memory; ROADMAP.md queues their redesign.

namespace {

enum LegacyMode { kDx = 0, kDw2 = 1, kDw1 = 2 };

// Shared-memory tiles of the legacy token kernel, rows padded by 16 bytes
// against bank conflicts in the WMMA fragment loads: x, dout and dy [BT, C]
// bf16, the W1 [C, FC] and W2 [FC, C] slices, z, g and dh [BT, FC] fp32, dz
// [BT, FC] bf16, the dx accumulator [BT, C] fp32, p and dp [BT, E] fp32;
// each mode allocates only what it uses.
struct LegacyLayout {
  int ldx, ldw1, ldw2, ldz, ldh, ldacc;
  size_t x, dout, dy, w1, w2, z, g, dh, h, acc, p, dp, total;
  __host__ __device__ LegacyLayout(int mode, int BT, int FC, int C, int E) {
    const bool dx = mode == kDx, with_dh = mode != kDw2;
    ldx = C + 8;
    ldw1 = FC + 8;
    ldw2 = C + 8;
    ldz = FC + 4;
    ldh = FC + 8;
    ldacc = C + 4;
    size_t off = 0;
    x = off; off += align128(sizeof(bf16) * BT * ldx);
    dout = off; off += align128(sizeof(bf16) * BT * ldx);
    dy = off; if (with_dh) off += align128(sizeof(bf16) * BT * ldx);
    w1 = off; off += align128(sizeof(bf16) * C * ldw1);
    w2 = off; if (with_dh) off += align128(sizeof(bf16) * FC * ldw2);
    z = off; off += align128(sizeof(float) * BT * ldz);
    g = off; if (dx) off += align128(sizeof(float) * BT * ldz);
    dh = off; if (with_dh) off += align128(sizeof(float) * BT * ldz);
    h = off; if (dx) off += align128(sizeof(bf16) * BT * ldh);
    acc = off; if (dx) off += align128(sizeof(float) * BT * ldacc);
    p = off; off += align128(sizeof(float) * BT * E);
    dp = off; if (dx) off += align128(sizeof(float) * BT * E);
    total = off;
  }
};

// Outputs by mode: kDx: ws_dx [splits, T, C] and ws_dp [splits, T, E] fp32
// partials. kDw2: sc_f = h [T, E*F], sc_dy = dy [T, E*C] (bf16), part_bias =
// [ntiles, E*C] column sums of p dout. kDw1: sc_f = dz [T, E*F] (bf16),
// part_bias = [ntiles, E*F] column sums of dz. Pointers a mode does not use
// may be null.
template <int kMode>
__global__ void __launch_bounds__(NTHREADS)
moe_legacy_token_kernel(const bf16* __restrict__ x, const bf16* __restrict__ fw,
                        const float* __restrict__ cw, const float* __restrict__ tl,
                        const float* __restrict__ inv_temp, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, const bf16* __restrict__ dout,
                        float* __restrict__ ws_dx, float* __restrict__ ws_dp,
                        bf16* __restrict__ sc_f, bf16* __restrict__ sc_dy,
                        float* __restrict__ part_bias, int T, int C, int Hd, int E, int F,
                        int BT, int FC) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LegacyLayout L(kMode, BT, FC, C, E);
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* sDY = reinterpret_cast<bf16*>(smem + L.dy);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + L.w2);
  float* sZ = reinterpret_cast<float*>(smem + L.z);
  float* sG = reinterpret_cast<float*>(smem + L.g);
  float* sDH = reinterpret_cast<float*>(smem + L.dh);
  bf16* sH = reinterpret_cast<bf16*>(smem + L.h);
  float* sAcc = reinterpret_cast<float*>(smem + L.acc);
  float* sP = reinterpret_cast<float*>(smem + L.p);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int t0 = tile * BT;
  const int rows = min(BT, T - t0);
  const int EF = E * F;

  stage_rows(sX, L.ldx, x + (long long)t0 * C, BT, rows, C);
  stage_rows(sDO, L.ldx, dout + (long long)t0 * C, BT, rows, C);
  for (int i = tid; i < BT * E; i += NTHREADS) {
    sP[i] = 0.f;
    if constexpr (kMode == kDx) sDP[i] = 0.f;
  }
  if constexpr (kMode == kDx) {
    for (int i = tid; i < BT * L.ldacc; i += NTHREADS) sAcc[i] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  router_tile(sX, L.ldx, fw, cw, tl, inv_temp, sW1, L.ldw1, sZ, L.ldz, sP, t0, rows, BT, C, Hd,
              E, FC);

  const int nfc = F / FC, nch = E * nfc;
  const int ch_end = (int)((long long)(split + 1) * nch / splits);
  int cur_e = -1;
  for (int ch = (int)((long long)split * nch / splits); ch < ch_end; ++ch) {
    const int e = ch / nfc, f0 = (ch % nfc) * FC;
    if constexpr (kMode == kDw2) {
      // One block per (tile, expert) meets f0 == 0: it writes that expert's
      // dy rows and the tile's column sums of p_e dout.
      if (f0 == 0) {
        for (int i = tid; i < rows * C; i += NTHREADS) {
          const int r = i / C, c = i % C;
          sc_dy[(long long)(t0 + r) * E * C + e * C + c] =
              __float2bfloat16(sP[r * E + e] * __bfloat162float(sDO[r * L.ldx + c]));
        }
        for (int c = tid; c < C; c += NTHREADS) {
          float s = 0.f;
          for (int r = 0; r < rows; ++r) s = fmaf(sP[r * E + e], __bfloat162float(sDO[r * L.ldx + c]), s);
          part_bias[(long long)tile * E * C + e * C + c] = s;
        }
      }
    } else {
      if (e != cur_e) {  // dy_e = bf16(p_e dout) for this expert's chunks
        for (int i = tid; i < BT * C; i += NTHREADS) {
          const int r = i / C, c = i % C;
          sDY[r * L.ldx + c] = __float2bfloat16(sP[r * E + e] * __bfloat162float(sDO[r * L.ldx + c]));
        }
        cur_e = e;
      }
      stage_rows(sW2, L.ldw2, w2 + ((long long)e * F + f0) * C, FC, FC, C);
    }
    stage_cols(sW1, L.ldw1, w1 + (long long)e * C * F, C, F, f0, FC, F);
    cp_async_wait_all();
    __syncthreads();

    // z = x W1 slice; g = dout W2 slice^T; dh = dy W2 slice^T (W2 slice
    // [FC, C] read column-major).
    mma_tiles<wmma::row_major, wmma::row_major>(sX, L.ldx, sW1, L.ldw1, sZ, L.ldz, BT, FC, C,
                                                false);
    if constexpr (kMode == kDx) {
      mma_tiles<wmma::row_major, wmma::col_major>(sDO, L.ldx, sW2, L.ldw2, sG, L.ldz, BT, FC, C,
                                                  false);
    }
    if constexpr (kMode != kDw2) {
      mma_tiles<wmma::row_major, wmma::col_major>(sDY, L.ldx, sW2, L.ldw2, sDH, L.ldz, BT, FC,
                                                  C, false);
    }
    __syncthreads();

    for (int i = tid; i < BT * FC; i += NTHREADS) {
      const int r = i / FC, j = i % FC;
      const float z = sZ[r * L.ldz + j] + b1[(long long)e * F + f0 + j];
      const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
      const long long at = (long long)(t0 + r) * EF + e * F + f0 + j;
      if constexpr (kMode == kDw2) {
        if (r < rows) sc_f[at] = __float2bfloat16(z * cdf);
      } else {
        const float dz =
            sDH[r * L.ldz + j] * (cdf + z * 0.3989422804014327f * expf(-0.5f * z * z));
        if constexpr (kMode == kDx) {
          const float hv = __bfloat162float(__float2bfloat16(z * cdf));
          sG[r * L.ldz + j] *= hv;
          sH[r * L.ldh + j] = __float2bfloat16(dz);
        } else {
          sZ[r * L.ldz + j] = dz;
          if (r < rows) sc_f[at] = __float2bfloat16(dz);
        }
      }
    }
    __syncthreads();

    if constexpr (kMode == kDx) {
      // Row sums of g*h into dp[:, e]; dx += bf16(dz) W1 slice^T.
      for (int r = tid; r < BT; r += NTHREADS) {
        float s = 0.f;
        for (int j = 0; j < FC; ++j) s += sG[r * L.ldz + j];
        sDP[r * E + e] += s;
      }
      mma_tiles<wmma::row_major, wmma::col_major>(sH, L.ldh, sW1, L.ldw1, sAcc, L.ldacc, BT, C,
                                                  FC, true);
    } else if constexpr (kMode == kDw1) {
      for (int j = tid; j < FC; j += NTHREADS) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += sZ[r * L.ldz + j];
        part_bias[(long long)tile * EF + e * F + f0 + j] = s;
      }
    }
    __syncthreads();
  }

  if constexpr (kMode == kDx) {
    float* dx_part = ws_dx + ((long long)split * T + t0) * C;
    for (int i = tid; i < rows * C; i += NTHREADS) {
      const int r = i / C, c = i % C;
      dx_part[i] = sAcc[r * L.ldacc + c];
    }
    float* dp_part = ws_dp + ((long long)split * T + t0) * E;
    for (int i = tid; i < rows * E; i += NTHREADS) {
      float bias = 0.f;
      if (split == 0) {  // dout . b2_e, once per token
        const int r = i / E, e = i % E;
        for (int c = 0; c < C; ++c)
          bias = fmaf(__bfloat162float(sDO[r * L.ldx + c]), b2[(long long)e * C + c], bias);
      }
      dp_part[i] = sDP[i] + bias;
    }
  }
}

// Largest token tile, then widest F-chunk, whose shared memory fits.
bool pick_legacy_tiles(int mode, int C, int F, int E, int* bt, int* fc) {
  const int bts[] = {64, 32, 16};
  const int fcs[] = {64, 32, 16};
  for (int b : bts) {
    for (int f : fcs) {
      if (F % f != 0) continue;
      if (LegacyLayout(mode, b, f, C, E).total <= SMEM_LIMIT) {
        *bt = b;
        *fc = f;
        return true;
      }
    }
  }
  return false;
}

template <int kMode>
int launch_legacy_token(const void* x, const void* fw, const void* cw, const void* tl,
                        const void* inv_temp, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* dout, void* ws_dx, void* ws_dp, void* sc_f,
                        void* sc_dy, void* part_bias, int T, int C, int Hd, int E, int F,
                        const int* plan, cudaStream_t st) {
  int bt = 0, fc = 0;
  if (!pick_legacy_tiles(kMode, C, F, E, &bt, &fc) || bt != plan[0] || fc != plan[1] ||
      plan[2] < 1 || plan[2] > 65535 || plan[3] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const LegacyLayout L(kMode, bt, fc, C, E);
  cudaError_t err = cudaFuncSetAttribute(moe_legacy_token_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_legacy_token_kernel<kMode><<<dim3((T + bt - 1) / bt, plan[2]), NTHREADS, L.total, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(fw), static_cast<const float*>(cw),
      static_cast<const float*>(tl), static_cast<const float*>(inv_temp),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(dout), static_cast<float*>(ws_dx),
      static_cast<float*>(ws_dp), static_cast<bf16*>(sc_f), static_cast<bf16*>(sc_dy),
      static_cast<float*>(part_bias), T, C, Hd, E, F, bt, fc);
  return static_cast<int>(cudaGetLastError());
}

// out [n] = the sum of ws [k, n] over k < count, in order.
int sum_into(const void* ws, void* out, long long n, int count, cudaStream_t st) {
  moe_sum_kernel<<<grid_for(n), 256, 0, st>>>(static_cast<const float*>(ws),
                                                static_cast<float*>(out), n, count);
  return static_cast<int>(cudaGetLastError());
}

// out [M, N] = A^T B over T tokens through `splits` partials in ws (null
// when splits == 1).
int wgrad(const void* A, int lda, const void* B, int ldb, void* ws, void* out, int T, int M,
          int N, int splits, cudaStream_t st) {
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  const dim3 grid((N + WT - 1) / WT, (M + WT - 1) / WT, splits);
  moe_wgrad_kernel<<<grid, NTHREADS, 0, st>>>(static_cast<const bf16*>(A),
                                              static_cast<const bf16*>(B), dst, T, M, N, lda,
                                              ldb, wgrad_chunk(T, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return sum_into(ws, out, (long long)M * N, splits, st);
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The plan of one legacy entry point (mode 0 dx, 1 dw2, 2 dw1) at
// (T, C, F, E) on a card with `sms` SMs: plan[0..3] = token tile, F-chunk,
// splits of the (expert, F-chunk) loop, and the T splits of the weight-
// gradient product (1 for dx). Returns 0 if no tile fits shared memory.
int moegan_moe_legacy_plan(int mode, int T, int C, int F, int E, int sms, int* plan) {
  int bt = 0, fc = 0;
  if (mode < kDx || mode > kDw1 || !pick_legacy_tiles(mode, C, F, E, &bt, &fc)) return 0;
  const int ntiles = (T + bt - 1) / bt;
  const int nch = E * (F / fc);
  const int s = (sms + ntiles - 1) / ntiles;
  plan[0] = bt;
  plan[1] = fc;
  plan[2] = s < 1 ? 1 : (s > nch ? nch : s);
  plan[3] = mode == kDw1 ? wgrad_splits(T, C, E * F, sms)
                         : (mode == kDw2 ? wgrad_splits(T, F, C, sms) : 1);
  return 1;
}

// dx_ffn [T, C] and dp [T, E], fp32 (replaces _bwd_dx_kernel). ws_dx
// [plan[2], T, C] and ws_dp [plan[2], T, E] fp32 scratch.
int moegan_moe_bwd_dx(const void* x, const void* fw, const void* cw, const void* tl,
                      const void* inv_temp, const void* w1, const void* b1, const void* w2,
                      const void* b2, const void* dout, void* ws_dx, void* ws_dp, void* dx,
                      void* dp, int T, int C, int Hd, int E, int F, const int* plan,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_legacy_token<kDx>(x, fw, cw, tl, inv_temp, w1, b1, w2, b2, dout, ws_dx, ws_dp,
                                     nullptr, nullptr, nullptr, T, C, Hd, E, F, plan, st);
  if (err) return err;
  if ((err = sum_into(ws_dx, dx, (long long)T * C, plan[2], st))) return err;
  return sum_into(ws_dp, dp, (long long)T * E, plan[2], st);
}

// dW2 [E, F, C] and db2 [E, C], fp32 (replaces _bwd_dw2_kernel). Scratch:
// h [T, E*F] and dy [T, E*C] bf16, part_db2 [ceil(T / plan[0]), E*C] fp32,
// ws_w [E, plan[3], F, C] fp32 (null when plan[3] == 1).
int moegan_moe_bwd_dw2(const void* x, const void* fw, const void* cw, const void* tl,
                       const void* inv_temp, const void* w1, const void* b1, const void* dout,
                       void* h, void* dy, void* part_db2, void* ws_w, void* dw2, void* db2, int T,
                       int C, int Hd, int E, int F, const int* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan[3] > 1 && ws_w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_legacy_token<kDw2>(x, fw, cw, tl, inv_temp, w1, b1, nullptr, nullptr, dout,
                                      nullptr, nullptr, h, dy, part_db2, T, C, Hd, E, F, plan, st);
  if (err) return err;
  const long long fcn = (long long)F * C;
  for (int e = 0; e < E; ++e) {
    err = wgrad(static_cast<const bf16*>(h) + (long long)e * F, E * F,
                static_cast<const bf16*>(dy) + (long long)e * C, E * C,
                plan[3] > 1 ? static_cast<float*>(ws_w) + e * plan[3] * fcn : nullptr,
                static_cast<float*>(dw2) + e * fcn, T, F, C, plan[3], st);
    if (err) return err;
  }
  return sum_into(part_db2, db2, (long long)E * C, (T + plan[0] - 1) / plan[0], st);
}

// dW1s [C, E*F] (expert e's dW1 in columns e*F ...) and db1 [E*F], fp32
// (replaces _bwd_dw1_kernel). Scratch: dz [T, E*F] bf16, part_db1
// [ceil(T / plan[0]), E*F] fp32, ws_w [plan[3], C, E*F] fp32 (null when
// plan[3] == 1).
int moegan_moe_bwd_dw1(const void* x, const void* fw, const void* cw, const void* tl,
                       const void* inv_temp, const void* w1, const void* b1, const void* w2,
                       const void* dout, void* dz, void* part_db1, void* ws_w, void* dw1s,
                       void* db1, int T, int C, int Hd, int E, int F, const int* plan,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan[3] > 1 && ws_w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_legacy_token<kDw1>(x, fw, cw, tl, inv_temp, w1, b1, w2, nullptr, dout,
                                      nullptr, nullptr, dz, nullptr, part_db1, T, C, Hd, E, F,
                                      plan, st);
  if (err) return err;
  if ((err = wgrad(x, C, dz, E * F, ws_w, dw1s, T, C, E * F, plan[3], st))) return err;
  return sum_into(part_db1, db1, (long long)E * F, (T + plan[0] - 1) / plan[0], st);
}

}  // extern "C"
