// Register-tile building blocks shared by fused_moe.cu, fused_moe_bwd.cu and
// fused_moe_legacy.cu: the block shapes of each padded width, the staging of
// token and weight tiles, the warp products, the erf-GELU, and the pieces of
// the weight gradients (the recompute block's shape and db1 sums, the
// scratch route's tiled product).
//
// Widths. A kernel is compiled for a padded width CP in {32, 64, 128, 256,
// 512} and takes any C <= CP that is a multiple of 16: shared tiles are
// CP wide, columns at or past C (and hidden units at or past F) are
// zero-filled, so they add nothing to any product, and nothing past C or F
// is stored. The token kernels walk the hidden units in chunks of FC = 64.
//
// Token-kernel blocks (Tile<CP>): RW row strips of 16 tokens; each strip's
// C output columns are split over CW warps (CW = 1 up to CP = 128, where
// one warp's [16, CP] fp32 accumulator is CP / 2 <= 64 registers a thread).
// A warp computes FC / CW of a chunk's hidden columns for its strip; with
// CW > 1 the strip's bf16 activations go through a small [BT, FC] shared
// tile so that every column warp has the whole chunk as its A operand.
// With CW = 1 the weight slices are small enough to double-buffer (NB = 2):
// the next chunk's slices land while this chunk is computed, one barrier a
// chunk; with CW > 1 one buffer each, the W2 slice landing while the first
// product runs and the next W1 slice while the second does.

#pragma once

#include "flash_mma.cuh"

namespace moe {

using namespace flash;

constexpr int FC = 64;     // hidden units per (expert, chunk) step of the token kernels
constexpr int MAX_E = 16;  // experts a kernel takes
constexpr int PE = 16;     // row stride of the [rows, E] fp32 tiles in shared memory

template <int CP>
struct Tile {
  static constexpr int CW = CP <= 128 ? 1 : CP / 128;  // warps sharing a strip's columns
  static constexpr int RW = CP <= 256 ? 4 : 2;         // 16-token strips a block
  static constexpr int NW = RW * CW;
  static constexpr int NT = 32 * NW;
  static constexpr int BT = 16 * RW;         // tokens a block
  static constexpr int NZ = FC / (8 * CW);   // 16x8 tiles of a chunk a warp computes
  static constexpr int NA = CP / (8 * CW);   // 16x8 output tiles a warp accumulates
  static constexpr int NB = CW == 1 ? 2 : 1;  // buffers of each weight slice
  static_assert(NZ >= 2 && NZ % 2 == 0 && NA % 2 == 0, "warp tiles come in 16-column pairs");
};

__host__ __device__ constexpr int padded_width(int C) {
  return C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : C <= 256 ? 256 : C <= 512 ? 512 : 0;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Phi(z) = 0.5 (1 + erf(z / sqrt 2)), with erf by Abramowitz-Stegun 7.1.26
// (|error| <= 1.5e-7), as moegan_tpu/ops/fused_moe.py::_erf_poly computes it:
// one reciprocal, one ex2 and five FMAs. `ez` returns exp(-z^2 / 2), which
// the GELU's derivative reuses: gelu'(z) = Phi(z) + z * ez / sqrt(2 pi).
__device__ __forceinline__ float gelu_cdf(float z, float& ez) {
  const float ax = fabsf(z) * 0.70710678118654752f;
  const float t = fast_rcp(fmaf(0.3275911f, ax, 1.f));
  ez = fast_exp2(-0.72134752044448170f * z * z);  // exp(-z^2 / 2) = 2^(-z^2 log2(e) / 2)
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  return 0.5f + copysignf(0.5f - 0.5f * poly * ez, z);
}

constexpr float INV_SQRT_2PI = 0.3989422804014327f;

// Rows r0 .. r0 + ROWS - 1 and columns c0 .. c0 + COLS - 1 of a row-major bf16
// matrix with row stride `ld` into a shared tile of pitch COLS + 8, in 16-byte
// cp.async copies; rows at or past `rlim` and columns at or past `clim` are
// zero-filled. All NT threads of the block take part; the caller commits.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long ld, int r0,
                                           int rlim, int c0, int clim) {
  constexpr int PER = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * PER; i += NT) {
    const int r = i / PER, c = (i % PER) * 8;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    cp_async16(dst + r * pitch(COLS) + c, ok ? src + (long long)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// A fragment of the 16x16 block (rows m0.., columns k0..) of X^T, X row-major
// [k][m] in a shared tile of width D (ldmatrix.trans).
template <int D>
__device__ __forceinline__ void load_at(uint32_t (&a)[4], const bf16* tile, int m0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(a, tile + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch(D) + m0 + ((lane >> 3) & 1) * 8);
}

template <int N>
__device__ __forceinline__ void zero_tiles(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// c[N] += A B for the warp's 16 rows row0.. of A (shared, width WA, K = 16 KS
// columns from k0) and B row-major [k][n] (shared, width WB; columns n0 ..
// n0 + 8N - 1).
template <int KS, int N, int WA, int WB>
__device__ __forceinline__ void mma_kn(float (&c)[N][4], const bf16* sA, int row0, int k0,
                                       const bf16* sB, int n0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    load_a<WA>(a, sA, row0, k0 + kk * 16);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      load_b<WB>(b, sB, k0 + kk * 16, n0 + np * 16);
      mma(c[2 * np], a, b[0], b[1]);
      mma(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// c[N] += A B^T, B row-major [n][k] (shared, width WB; rows n0 .. n0 + 8N - 1).
template <int KS, int N, int WA, int WB>
__device__ __forceinline__ void mma_nk(float (&c)[N][4], const bf16* sA, int row0, int k0,
                                       const bf16* sB, int n0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    load_a<WA>(a, sA, row0, k0 + kk * 16);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      load_bt<WB>(b, sB, n0 + np * 16, k0 + kk * 16);
      mma(c[2 * np], a, b[0], b[1]);
      mma(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The A fragment of k-step ks from a warp's C tiles packed to bf16x2 pairs
// (p[n][0]: row g, p[n][1]: row g + 8): tiles 2 ks and 2 ks + 1 side by side.
template <int N>
__device__ __forceinline__ void packed_a(uint32_t (&a)[4], const uint32_t (&p)[N][2], int ks) {
  a[0] = p[2 * ks][0];
  a[1] = p[2 * ks][1];
  a[2] = p[2 * ks + 1][0];
  a[3] = p[2 * ks + 1][1];
}

// The recompute route's weight-gradient block: FW = 64 hidden units of one
// expert (4 m-tiles of 16), 8 warps. Warp (mw = warp / KS, kw = warp % KS)
// takes m-tile mw and, in each group of BTK tokens, the tokens kw * 16..
struct WTile {
  static constexpr int FW = 64, MF = FW / 16, NW = 8, NT = 32 * NW, KS = NW / MF;
  static constexpr int BTK = 16 * KS;
};

// db1 of a WTile block's hidden units f0 .. f0 + FW - 1: each warp's sums
// r[0] (unit mw * 16 + g) and r[1] (+ 8) over its tokens, added over the
// quad, then over the KS token groups in order through red [KS][FW]; out[f]
// for the units f < F. Every thread of the block calls it.
__device__ __forceinline__ void wtile_unit_sums(float (&r)[2], float* red, float* out, int f0,
                                                int F) {
  using W = WTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  const int mw = warp / W::KS, kw = warp % W::KS, FW = W::FW;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    r[half] += __shfl_xor_sync(0xffffffffu, r[half], 1);
    r[half] += __shfl_xor_sync(0xffffffffu, r[half], 2);
  }
  if (tq == 0) {  // hidden units mw * 16 + g (+ 8), token group kw
    red[kw * FW + mw * 16 + g] = r[0];
    red[kw * FW + mw * 16 + g + 8] = r[1];
  }
  __syncthreads();
  if (tid < FW && f0 + tid < F) {
    float sum = 0.f;
    for (int k = 0; k < W::KS; ++k) sum += red[k * FW + tid];
    out[f0 + tid] = sum;
  }
}

// The scratch route's tiled product: out[M, N] = A[tb:te]^T B[tb:te] for
// bf16 row-major A [T, M] and B [T, N], out fp32 row-major. Block x owns a
// [GBM, GBN] output tile, kept in registers (8 warps of 32 x 64, 64 a
// thread) while the block walks its tokens GBK at a time, A and B
// double-buffered by cp.async; A^T's fragments come by ldmatrix.trans. Run
// by 256 threads.
constexpr int GBM = 128, GBN = 128, GBK = 32;

__device__ __forceinline__ void wgrad_gemm_tile(const bf16* __restrict__ A,
                                                const bf16* __restrict__ B,
                                                float* __restrict__ out, int M, int N, int tb,
                                                int te) {
  __shared__ __align__(128) bf16 sA[2][GBK * pitch(GBM)];
  __shared__ __align__(128) bf16 sB[2][GBK * pitch(GBN)];
  const int ntn = (N + GBN - 1) / GBN;
  const int m0 = (blockIdx.x / ntn) * GBM, n0 = (blockIdx.x % ntn) * GBN;
  const int ntile = te > tb ? (te - tb + GBK - 1) / GBK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;

  auto issue = [&](int j) {
    stage_tile<GBK, GBM, 256>(sA[j & 1], A, M, tb + j * GBK, te, m0, M);
    stage_tile<GBK, GBN, 256>(sB[j & 1], B, N, tb + j * GBK, te, n0, N);
    cp_async_commit();
  };
  float acc[2][8][4];
  zero_tiles(acc[0]);
  zero_tiles(acc[1]);
  if (ntile > 0) issue(0);
  for (int j = 0; j < ntile; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < ntile) issue(j + 1);
#pragma unroll
    for (int ks = 0; ks < GBK / 16; ++ks) {
      uint32_t a[2][4];
      load_at<GBM>(a[0], sA[j & 1], wm, ks * 16);
      load_at<GBM>(a[1], sA[j & 1], wm + 16, ks * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_b<GBN>(b, sB[j & 1], ks * 16, wn + np * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n0 + wn + n * 8 + 2 * tq;
        if (c < N)
          *reinterpret_cast<float2*>(out + (long long)m * N + c) =
              make_float2(acc[mi][n][2 * half], acc[mi][n][2 * half + 1]);
      }
    }
  }
}

}  // namespace moe
