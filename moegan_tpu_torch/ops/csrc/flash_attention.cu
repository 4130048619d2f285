// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel moegan_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_forward), in its default form: q pre-scaled to
// q_pre = bf16(q * bf16(log2(e)/sqrt(D))), base-2 online softmax with an fp32
// running max, denominator and accumulator, and the denominator summed from
// the same bf16-rounded p that multiplies V ("fused_l"). o = bf16(acc / l).
// The optional output is the base-2 logsumexp per row, lse = m + log2(l),
// [B, H, T] fp32, which the backward reads; the call without it computes the
// same o bits.
//
// Layout: q, k, v are [B, T, H, D] read through their strides (the last one
// must be 1, the others multiples of 8, the base 16-byte aligned), so the
// q|k|v slices of a fused QKV projection need no copy. o is a contiguous
// [B, T, H, D]. D is 16, 32, 48 or 64; T is any length (ragged q rows and
// keys past T are masked).
//
// What bounds it: at the repo's shapes (T = 256 / 1024 / 4096, D = 16 / 32)
// a score costs 4*D = 64-128 tensor-core FLOPs but one exponential. At the
// bf16 wgmma peak (989 TFLOP/s) over the SFU's ex2 rate (16 per SM per clock,
// ~4.2e12/s at 1.98 GHz), ~237 FLOPs per exponential, the B*H*T^2
// exponentials set the floor. With mma.sync the tensor side comes close to
// it: scripts/torch_mma_ex2_rates.py measured 541-570 TFLOP/s for
// m16n8k16 and 4.0e12 ex2/s on an H100 80GB HBM3 at 700 W, and a mix of the
// two only partly overlapped (1.3x the slower alone). Per 16-row x 64-key
// tile at D = 32 a warp issues 36 MMAs (S, P V, and l) and 34 ex2, ~270
// clocks of each on one SM sub-partition, plus ~130 other instructions.
//
// Design: one block of 4 warps per (b*h, q tile) of 64 or 128 rows; the host
// picks the tile (ops/flash_attention.py::flash_plan). Each warp owns one
// or two 16-row strips (MT), whose pre-scaled Q fragments it loads once
// with ldmatrix into registers; with two strips every K and V fragment it
// loads feeds both. Per 64-key tile:
//   - S = Q_pre K^T with mma.sync m16n8k16 (bf16 in, fp32 accumulate) into
//     registers: 8 C tiles of 16x8 a strip, K through ldmatrix;
//   - the softmax in the accumulator layout: each thread holds two rows
//     (g and g+8); keys past T get -inf first; the row max is a tree over
//     the thread's 16 values and two shuffles across the quad; p = exp2(s -
//     m) (ex2.approx.ftz) is rounded and packed to bf16x2 in registers;
//   - the packed P is directly the A operand of O += P V (V through
//     ldmatrix.trans) and of l += P 1 (a ones B operand), so l sums exactly
//     the rounded p that multiplies V, on the tensor cores, in a fixed order;
//     O and l are rescaled by exp2(m_old - m_new) in registers.
// No fp32 S, P or O tile lives in shared memory. K/V tiles are
// double-buffered with cp.async (16 B, zero-filled past T): the next tile's
// copy is issued before this tile's math, with one barrier per tile. Shared
// rows are padded to D + 8 so ldmatrix has no bank conflicts. The epilogue
// stages o through the warp's own (by then unused) Q rows for 16-byte stores.
// No atomics; every fp32 sum runs in a fixed order, so two calls give the
// same bits. Measured and dropped: 8-warp blocks, three cp.async stages and
// S computed one tile ahead (each cost occupancy and ran slower).
//
// Left for later: wgmma with ping-pong warpgroups so the exponentials of one
// tile overlap the products of the other; part of the exponentials by a
// polynomial on the FMA units; TMA in place of cp.async.

#include "flash_mma.cuh"

using namespace flash;

namespace {

constexpr int NW = 4;  // warps a block

// Dynamic shared memory of the forward at head dim D with MT 16-row strips
// a warp: the Q tile and two stages of K and V tiles, rows padded to D + 8.
constexpr int fwd_smem_bytes(int D, int MT) {
  return (16 * NW * MT + 2 * 2 * KV_TILE) * pitch(D) * 2;
}

constexpr uint32_t BF16X2_ONES = 0x3F803F80u;  // (1.0, 1.0) in bf16

// S = Q_pre K^T for the warp's MT strips against one tile of 8 * NS keys.
template <int ND, int MT, int NS>
__device__ __forceinline__ void qk_tile(float (&s)[MT][NS][4], const uint32_t (&qf)[MT][ND][4],
                                        const bf16* sK) {
  constexpr int D = 16 * ND;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t bk[4];
      load_bt<D>(bk, sK, np * 16, kk * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
        mma(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
      }
    }
  }
}

// The online softmax of one tile's S (keys kv0 ..) and O += P V, l += P 1.
template <int ND, int MT, int NS>
__device__ __forceinline__ void softmax_pv(float (&s)[MT][NS][4], float (&acc)[MT][2 * ND][4],
                                           float (&lacc)[MT][4], float (&m)[MT][2],
                                           const bf16* sV, int kv0, int T) {
  constexpr int D = 16 * ND, BK = NS * 8;
  const int tq = threadIdx.x & 3;
  if (kv0 + BK > T) {  // the ragged last tile: keys past T get -inf
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int key = kv0 + n * 8 + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (key >= T) s[mt][n][0] = s[mt][n][2] = -INFINITY;
        if (key + 1 >= T) s[mt][n][1] = s[mt][n][3] = -INFINITY;
      }
    }
  }

  uint32_t p[MT][NS][2];  // bf16x2: row g, row g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // The thread's row maxima as a tree (depth log2(2 NS), not a chain of 2 NS).
    float r0[NS], r1[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      r0[n] = fmaxf(s[mt][n][0], s[mt][n][1]);
      r1[n] = fmaxf(s[mt][n][2], s[mt][n][3]);
    }
#pragma unroll
    for (int w = NS / 2; w > 0; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) {
        r0[n] = fmaxf(r0[n], r0[n + w]);
        r1[n] = fmaxf(r1[n], r1[n + w]);
      }
    float mx0 = fmaxf(m[mt][0], r0[0]), mx1 = fmaxf(m[mt][1], r1[0]);
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile holds at least one key below T, so mx0 and mx1 are finite.
    const float alpha0 = fast_exp2(m[mt][0] - mx0), alpha1 = fast_exp2(m[mt][1] - mx1);
    m[mt][0] = mx0;
    m[mt][1] = mx1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      p[mt][n][0] = pack_bf16(fast_exp2(s[mt][n][0] - mx0), fast_exp2(s[mt][n][1] - mx0));
      p[mt][n][1] = pack_bf16(fast_exp2(s[mt][n][2] - mx1), fast_exp2(s[mt][n][3] - mx1));
    }
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n) {
      acc[mt][n][0] *= alpha0;
      acc[mt][n][1] *= alpha0;
      acc[mt][n][2] *= alpha1;
      acc[mt][n][3] *= alpha1;
    }
    lacc[mt][0] *= alpha0;
    lacc[mt][1] *= alpha0;
    lacc[mt][2] *= alpha1;
    lacc[mt][3] *= alpha1;
  }

  // O += P V: the 16 keys 16*kk .. 16*kk + 15 are C tiles 2kk and 2kk + 1.
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < ND; ++dp) {
      uint32_t bv[4];
      load_b<D>(bv, sV, kk * 16, dp * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t pa[4] = {p[mt][2 * kk][0], p[mt][2 * kk][1], p[mt][2 * kk + 1][0],
                                p[mt][2 * kk + 1][1]};
        mma(acc[mt][2 * dp], pa, bv[0], bv[1]);
        mma(acc[mt][2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    // l += P 1: the row sums of the rounded p, on the tensor cores.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t pa[4] = {p[mt][2 * kk][0], p[mt][2 * kk][1], p[mt][2 * kk + 1][0],
                              p[mt][2 * kk + 1][1]};
      mma(lacc[mt], pa, BF16X2_ONES, BF16X2_ONES);
    }
  }
}

template <int ND, int MT>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int H, Strides st, float scale) {
  constexpr int D = 16 * ND, LD = pitch(D), BQ = 16 * NW * MT, NT = 32 * NW, BK = KV_TILE;
  constexpr int NS = BK / 8;  // C tiles of S per 16-row strip
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BQ * LD;  // [stage][K, V][BK][LD]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane & 3;
  const int row0 = warp * 16 * MT;  // the warp's first row within the tile
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const int ntiles = (T + BK - 1) / BK;

  auto issue = [&](int t) {  // K and V of tile t into stage t % 2, one commit group
    bf16* dst = sKV + (t & 1) * 2 * BK * LD;
    stage_rows<D, NT>(dst, kb, st.kt, t * BK, BK, T);
    stage_rows<D, NT>(dst + BK * LD, vb, st.vt, t * BK, BK, T);
    cp_async_commit();
  };

  stage_rows<D, NT>(sQ, q + b * st.qb + h * st.qh, st.qt, q0, BQ, T);
  issue(0);  // with Q

  float acc[MT][2 * ND][4];
  float lacc[MT][4];  // row sums of the rounded p (c0: row g, c2: row g + 8)
  float m[MT][2];     // running max of rows g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    lacc[mt][0] = lacc[mt][1] = lacc[mt][2] = lacc[mt][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
  }

  uint32_t qf[MT][ND][4];
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1's stage
    if (j + 1 < ntiles) issue(j + 1);
    if (j == 0) {  // the pre-scaled Q fragments, once
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) {
          load_a<D>(qf[mt][kk], sQ, row0 + mt * 16, kk * 16);
#pragma unroll
          for (int r = 0; r < 4; ++r) qf[mt][kk][r] = scale_bf16x2(qf[mt][kk][r], scale);
        }
    }
    const bf16* sK = sKV + (j & 1) * 2 * BK * LD;
    float s[MT][NS][4];
    qk_tile<ND, MT, NS>(s, qf, sK);
    softmax_pv<ND, MT, NS>(s, acc, lacc, m, sK + BK * LD, j * BK, T);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = lacc[mt][0], l1 = lacc[mt][2];
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n) {
      acc[mt][n][0] /= l0;
      acc[mt][n][1] /= l0;
      acc[mt][n][2] /= l1;
      acc[mt][n][3] /= l1;
    }
    const int t0 = q0 + row0 + mt * 16;
    store_rows<D>(acc[mt], 1.f, sQ + (row0 + mt * 16) * LD, o, b, h, t0, T, H);
    if (lse != nullptr && tq == 0) {
      const int g = lane >> 2;
      float* lse_bh = lse + (long long)bh * T;
      if (t0 + g < T) lse_bh[t0 + g] = m[mt][0] + log2f(l0);
      if (t0 + g + 8 < T) lse_bh[t0 + g + 8] = m[mt][1] + log2f(l1);
    }
  }
}

template <int ND, int MT>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T,
               int H, const Strides& st, float scale, cudaStream_t s) {
  constexpr int BQ = 16 * NW * MT;
  constexpr int smem = fwd_smem_bytes(16 * ND, MT);
  static_assert(smem <= MAX_SMEM, "forward tiles exceed a block's shared memory");
  static unsigned attr_set = 0;
  const cudaError_t err = set_smem_once(flash_fwd_kernel<ND, MT>, smem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<ND, MT><<<grid, NW * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), T, H, st, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: q (b, t, h), k (b, t, h), v (b, t, h) in elements. lse may be
// null. block_q (64, or 128 for D <= 32) comes from flash_plan. Returns the
// cudaError_t of the launch.
int moegan_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int T, int H, int D, const long long* strides, int block_q,
                               float scale, void* stream) {
  const int MT = block_q / (16 * NW);
  if (D % 16 != 0 || D < 16 || D > 64 || (block_q != 64 && block_q != 128) ||
      (MT == 2 && D > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MT == 2)
    return D == 16 ? launch_fwd<1, 2>(q, k, v, o, lse, B, T, H, st, scale, s)
                   : launch_fwd<2, 2>(q, k, v, o, lse, B, T, H, st, scale, s);
  switch (D) {
    case 16: return launch_fwd<1, 1>(q, k, v, o, lse, B, T, H, st, scale, s);
    case 32: return launch_fwd<2, 1>(q, k, v, o, lse, B, T, H, st, scale, s);
    case 48: return launch_fwd<3, 1>(q, k, v, o, lse, B, T, H, st, scale, s);
    default: return launch_fwd<4, 1>(q, k, v, o, lse, B, T, H, st, scale, s);
  }
}

}  // extern "C"
