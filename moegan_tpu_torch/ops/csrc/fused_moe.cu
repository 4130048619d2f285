// Fused Bayesian-MoE forward for Hopper (sm_90a): router + all-expert FFN +
// probability-weighted combine in one kernel.
//
// Replaces both TPU kernels moegan_tpu/ops/fused_moe.py::_fused_moe_kernel
// (v1, one program per token tile x expert) and ::_fused_moe_kernel_v2 (v2,
// stacked expert weights). The two compute the same function; on the TPU a
// VMEM gate chose between them. Here one kernel serves every block:
//
//   logits = ((x @ fw) @ cw_f + text_logits) * inv_temp, clipped to +-20
//   probs  = softmax -> floor 1e-6 -> renorm  (-> hard: multi-hot of the
//            maxima, renormalised, so a tie splits evenly)
//   out    = bf16(sum_e bf16(p_e * bf16(gelu(x @ W1_e + b1_e))) @ W2_e + probs @ b2)
//
// with gelu's erf by Abramowitz-Stegun 7.1.26, as the TPU kernels compute it
// (fused_moe.py:39-56, |error| <= 1.5e-7). The rounding of p_e*h to bf16
// before the second product is v2's (fused_moe.py:759); under hard routing
// it is exact.
//
// The same kernel, instantiated without the router (kRouter = false), is
// the expert-parallel combine moegan_moe_combine_fwd. It replaces the TPU
// kernels ::_combine_kernel (v1) and ::_combine_kernel_v2: the same sum over
// the E experts it is given (a rank's local shard), with probs [T, E] read
// from memory (soft, or one-hot at eval), written as the rank's bf16
// partial, which the caller adds over the ranks.
//
// What bounds it on the H100: 4*T*C*F*E tensor FLOPs (17.2 GFLOP a block of
// the 64x64 generator at training batch 64, 0.017 ms at the 989 TFLOP/s
// bf16 peak) and T*E*F GELUs of one reciprocal and one ex2 each on the SFUs
// (16 a clock on each SM: 0.025 ms a block at batch 64). Where each hidden
// unit has only 4C = 128-256 tensor FLOPs (C = 32-64, res 32 and 64) the
// GELU's ~20 FP32 instructions outweigh its MMAs: those blocks are
// elementwise-bound. Under hard routing at serving batch the weights'
// bytes bound it instead.
//
// Design (moe_tiles.cuh for the block shapes): block (i, s) of the grid
// takes token tile i (BT = 64 tokens, 32 at C > 256) and the s-th of
// `splits` contiguous ranges of the (expert, chunk of FC = 64 hidden units)
// loop, so a layer with few tiles still fills the card. Each warp owns a
// 16-token strip and CP / CW output columns:
//   - z = x W1[:, chunk] by mma.sync m16n8k16 (bf16 in, fp32 accumulate)
//     with x and the W1 slice read from shared memory by ldmatrix; z stays
//     in C fragments;
//   - b1, the GELU and p_e in registers; the C tile pairs packed to bf16x2
//     are the A fragments of acc += ph W2[chunk, :] (with CW > 1 they go
//     through a [BT, FC] bf16 tile, since each column warp needs the whole
//     chunk);
//   - the [16, CP / CW] fp32 output accumulator stays in registers for the
//     whole loop (<= 64 a thread).
// Weight slices are staged by cp.async: up to C = 128 both slices of the
// next used chunk land in a second buffer while this chunk is computed (one
// barrier a chunk); at C = 256-512, where two buffers of each would not fit
// beside the x tile, the W2 slice of a chunk lands while z is computed and
// the next W1 slice while ph W2 is. The router's x @ fw runs on the same
// warp products, FC router columns at a time, compiled for up to 4 experts
// (the model's) or 16. Under hard routing a block skips the experts that no
// token of its tile selected (their p_e is 0).
// With splits > 1 each block writes its partial sum to a [splits, T, C]
// workspace, and a second kernel of the same launch adds the partials in
// split order (so the result does not depend on which block ran when) plus
// probs @ b2. Ragged token tiles are masked; C <= 512 and F multiples of
// 16, the router width a multiple of 8, E at most 16. The splits come from
// ops/fused_moe.py::moe_plan, which this file checks.

#include "moe_tiles.cuh"

using namespace moe;

namespace {

// Routing probabilities of one token from its raw logits l (router product
// plus text logits): * inv_temp, clip +-20, softmax, floor 1e-6, renorm, and
// under `hard` the multi-hot of the maxima renormalised (a tie splits
// evenly), as moegan_tpu/ops/fused_moe.py::_routing_probs.
template <int NE>
__device__ __forceinline__ void route(float (&p)[NE], int E, float it, bool hard) {
  // Every loop is unrolled over NE >= E (experts past E skipped), so p stays in registers.
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (e < E) {
      p[e] = fminf(fmaxf(p[e] * it, -20.f), 20.f);
      mx = fmaxf(mx, p[e]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (e < E) {
      p[e] = expf(p[e] - mx);
      sum += p[e];
    }
  }
  float sum2 = 0.f;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (e < E) {
      p[e] = fminf(fmaxf(p[e] / sum, 1e-6f), 1.f);
      sum2 += p[e];
    }
  }
  float pmax = 0.f;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (e < E) {
      p[e] = p[e] / sum2;
      pmax = fmaxf(pmax, p[e]);
    }
  }
  if (hard) {
    float n = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) n += (e < E && p[e] == pmax) ? 1.f : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) p[e] = (p[e] == pmax) ? 1.f / n : 0.f;
  }
}

// The routing of a token tile (rows t0 .. t0 + BT - 1 of T), into sP [BT][PE]
// (zero for rows past T). The router product x @ fw runs on the tensor cores
// FC hidden columns at a time: fw's columns staged into sW ([CP][FC + 8], the
// W1 slice buffer), each warp taking its strip and its FC / CW columns, then
// times cw_f in fp32 into per-thread logit sums, reduced across the quad by
// shuffles and across the strip's column warps through sLG [CW][BT][PE] in
// warp order. With `used`, marks the experts that some token of the tile
// selects. Compiled for NE >= E experts (4, the model's, or MAX_E), so its
// loops over the experts are unrolled without idle iterations. Every thread
// calls it; sX must have landed; it ends in a barrier.
template <int CP, int NE>
__device__ void router_tile(const bf16* sX, bf16* sW, float* sLG, float* sP, int* used,
                            const bf16* __restrict__ fw, const float* __restrict__ cw,
                            const float* __restrict__ tl, const float* __restrict__ inv_temp,
                            int t0, int T, int C, int Hd, int E, bool hard) {
  using L = Tile<CP>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int row0 = (warp / L::CW) * 16, cg = warp % L::CW;
  float l0[NE], l1[NE];  // logit sums of rows g and g + 8 over this thread's columns
#pragma unroll
  for (int e = 0; e < NE; ++e) l0[e] = l1[e] = 0.f;
  for (int j0 = 0; j0 < Hd; j0 += FC) {
    stage_tile<CP, FC, L::NT>(sW, fw, Hd, 0, C, j0, Hd);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float z[L::NZ][4];
    zero_tiles(z);
    mma_kn<CP / 16, L::NZ, CP, FC>(z, sX, row0, 0, sW, cg * (FC / L::CW));
#pragma unroll
    for (int n = 0; n < L::NZ; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + cg * (FC / L::CW) + n * 8 + 2 * tq + h;
        if (j < Hd) {
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            if (e < E) {
              const float w = cw[j * E + e];
              l0[e] = fmaf(z[n][h], w, l0[e]);
              l1[e] = fmaf(z[n][2 + h], w, l1[e]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with sW before the next columns land
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (e < E) {  // the same for every lane
      l0[e] += __shfl_xor_sync(0xffffffffu, l0[e], 1);
      l0[e] += __shfl_xor_sync(0xffffffffu, l0[e], 2);
      l1[e] += __shfl_xor_sync(0xffffffffu, l1[e], 1);
      l1[e] += __shfl_xor_sync(0xffffffffu, l1[e], 2);
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (e < E) {
        sLG[(cg * L::BT + row0 + g) * PE + e] = l0[e];
        sLG[(cg * L::BT + row0 + g + 8) * PE + e] = l1[e];
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < L::BT; r += L::NT) {
    const bool ok = t0 + r < T;
    float p[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      float s = 0.f;
      if (e < E) {
        for (int c = 0; c < L::CW; ++c) s += sLG[(c * L::BT + r) * PE + e];
        if (ok) s += tl[(long long)(t0 + r) * E + e];
      }
      p[e] = s;
    }
    route(p, E, inv_temp[0], hard);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (e < E) {
        sP[r * PE + e] = ok ? p[e] : 0.f;
        if (used != nullptr && ok && p[e] > 0.f) used[e] = 1;
      }
    }
  }
  __syncthreads();
}

// router_tile for the E at hand: the 4-expert instance or the general one.
template <int CP>
__device__ void route_tile(const bf16* sX, bf16* sW, float* sLG, float* sP, int* used,
                           const bf16* __restrict__ fw, const float* __restrict__ cw,
                           const float* __restrict__ tl, const float* __restrict__ inv_temp, int t0,
                           int T, int C, int Hd, int E, bool hard) {
  if (E <= 4) {
    router_tile<CP, 4>(sX, sW, sLG, sP, used, fw, cw, tl, inv_temp, t0, T, C, Hd, E, hard);
  } else {
    router_tile<CP, MAX_E>(sX, sW, sLG, sP, used, fw, cw, tl, inv_temp, t0, T, C, Hd, E, hard);
  }
}

// Dynamic shared memory of the forward at padded width CP: the x tile, NB
// W1 slices [CP][FC] and NB W2 slices [FC][CP], with CW > 1 the [BT][FC] ph
// tile, and the [BT][PE] probabilities. The router's logit partials
// [CW][BT][PE] borrow the first W2 slice before the expert loop.
template <int CP>
constexpr int fwd_smem_bytes() {
  using L = Tile<CP>;
  return 2 * (L::BT * pitch(CP) + L::NB * (CP * pitch(FC) + FC * pitch(CP)) +
              (L::CW > 1 ? L::BT * pitch(FC) : 0)) +
         4 * L::BT * PE;
}

template <bool kRouter, int CP>
__global__ void __launch_bounds__(Tile<CP>::NT)
moe_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ fw,
               const float* __restrict__ cw, const float* __restrict__ tl,
               const float* __restrict__ inv_temp, const float* __restrict__ probs_in,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out,
               float* __restrict__ probs, float* __restrict__ ws, int T, int C, int Hd, int E,
               int F, int hard) {
  using L = Tile<CP>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_used[MAX_E];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // [BT][CP + 8]
  bf16* sW1 = sX + L::BT * pitch(CP);        // [NB][CP][FC + 8]
  bf16* sW2 = sW1 + L::NB * CP * pitch(FC);  // [NB][FC][CP + 8]
  bf16* sPH = sW2 + L::NB * FC * pitch(CP);  // [BT][FC + 8], CW > 1
  float* sP = reinterpret_cast<float*>(sPH + (L::CW > 1 ? L::BT * pitch(FC) : 0));  // [BT][PE]
  float* sLG = reinterpret_cast<float*>(sW2);  // [CW][BT][PE], the router's partials

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  const int row0 = (warp / L::CW) * 16, cg = warp % L::CW;
  const int split = blockIdx.y, splits = gridDim.y;
  const int t0 = blockIdx.x * L::BT;

  stage_tile<L::BT, CP, L::NT>(sX, x, C, t0, T, 0, C);
  cp_async_commit();
  if (tid < MAX_E) s_used[tid] = (kRouter && !hard) ? 1 : 0;
  cp_async_wait_all();
  __syncthreads();

  if constexpr (kRouter) {
    route_tile<CP>(sX, sW1, sLG, sP, hard ? s_used : nullptr, fw, cw, tl, inv_temp, t0, T, C, Hd,
                   E, hard != 0);
    if (split == 0) {
      for (int i = tid; i < L::BT * E; i += L::NT) {
        const int r = i / E, e = i % E;
        if (t0 + r < T) probs[(long long)(t0 + r) * E + e] = sP[r * PE + e];
      }
    }
  } else {
    // The given probabilities; an expert that no token of the tile weighs
    // (p exactly 0, as under one-hot routing) is skipped below.
    for (int i = tid; i < L::BT * PE; i += L::NT) {
      const int r = i / PE, e = i % PE;
      const float p = (e < E && t0 + r < T) ? probs_in[(long long)(t0 + r) * E + e] : 0.f;
      sP[i] = p;
      if (p != 0.f) s_used[e] = 1;
    }
    __syncthreads();
  }

  // This block's share of the (expert, chunk) loop, used experts only.
  const int nfc = (F + FC - 1) / FC, nch = E * nfc;
  const int ch_end = (int)((long long)(split + 1) * nch / splits);
  auto next_used = [&](int ch) {
    while (ch < ch_end && !s_used[ch / nfc]) ++ch;
    return ch;
  };
  auto stage_w1 = [&](int ch, int b) {
    stage_tile<CP, FC, L::NT>(sW1 + b * CP * pitch(FC), w1 + (long long)(ch / nfc) * C * F, F, 0,
                              C, (ch % nfc) * FC, F);
  };
  auto stage_w2 = [&](int ch, int b) {
    stage_tile<FC, CP, L::NT>(sW2 + b * FC * pitch(CP), w2 + (long long)(ch / nfc) * F * C, C,
                              (ch % nfc) * FC, F, 0, C);
  };

  float acc[L::NA][4];
  zero_tiles(acc);
  const int zc0 = cg * (FC / L::CW);  // the warp's first column of a chunk
  const int ac0 = cg * (CP / L::CW);  // the warp's first output column

  // z = x W1-slice, then ph = bf16(p_e * bf16(gelu(z + b1))) packed: ph[n][0]
  // row g, ph[n][1] row g + 8 (and, with CW > 1, into the ph tile).
  auto z_ph = [&](int ch, const bf16* w1s, uint32_t (&ph)[L::NZ][2]) {
    const int e = ch / nfc, f0 = (ch % nfc) * FC;
    float z[L::NZ][4];
    zero_tiles(z);
    mma_kn<CP / 16, L::NZ, CP, FC>(z, sX, row0, 0, w1s, zc0);
    const float pe0 = sP[(row0 + g) * PE + e], pe1 = sP[(row0 + g + 8) * PE + e];
#pragma unroll
    for (int n = 0; n < L::NZ; ++n) {
      const int f = f0 + zc0 + n * 8 + 2 * tq;  // F is even: f < F means f + 1 < F
      const float2 bb = f < F ? *reinterpret_cast<const float2*>(b1 + (long long)e * F + f)
                              : make_float2(0.f, 0.f);
      float ez;
      float h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float zz = z[n][i] + ((i & 1) ? bb.y : bb.x);
        h[i] = round_bf16(zz * gelu_cdf(zz, ez));
      }
      ph[n][0] = pack_bf16(h[0] * pe0, h[1] * pe0);
      ph[n][1] = pack_bf16(h[2] * pe1, h[3] * pe1);
      if constexpr (L::CW > 1) {
        *reinterpret_cast<uint32_t*>(sPH + (row0 + g) * pitch(FC) + zc0 + n * 8 + 2 * tq) = ph[n][0];
        *reinterpret_cast<uint32_t*>(sPH + (row0 + g + 8) * pitch(FC) + zc0 + n * 8 + 2 * tq) =
            ph[n][1];
      }
    }
  };
  // acc += ph W2-slice
  auto ph_w2 = [&](const bf16* w2s, const uint32_t (&ph)[L::NZ][2]) {
#pragma unroll
    for (int ks = 0; ks < FC / 16; ++ks) {
      uint32_t a[4];
      if constexpr (L::CW == 1) {
        packed_a(a, ph, ks);
      } else {
        load_a<FC>(a, sPH, row0, ks * 16);
      }
#pragma unroll
      for (int np = 0; np < L::NA / 2; ++np) {
        uint32_t b[4];
        load_b<CP>(b, w2s, ks * 16, ac0 + np * 16);
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  };

  int ch = next_used((int)((long long)split * nch / splits));
  if constexpr (L::NB == 2) {
    // Both slices of the next used chunk land while this one is computed.
    if (ch < ch_end) {
      stage_w1(ch, 0);
      stage_w2(ch, 0);
      cp_async_commit();
    }
    for (int b = 0; ch < ch_end; b ^= 1) {
      const int nxt = next_used(ch + 1);
      cp_async_wait_all();
      __syncthreads();  // chunk ch landed; every warp is done with buffer b ^ 1
      if (nxt < ch_end) {
        stage_w1(nxt, b ^ 1);
        stage_w2(nxt, b ^ 1);
        cp_async_commit();
      }
      uint32_t ph[L::NZ][2];
      z_ph(ch, sW1 + b * CP * pitch(FC), ph);
      ph_w2(sW2 + b * FC * pitch(CP), ph);
      ch = nxt;
    }
  } else {
    // One buffer each: the W2 slice lands while z is computed, the next W1
    // slice while ph W2 is.
    if (ch < ch_end) {
      stage_w1(ch, 0);
      cp_async_commit();
    }
    while (ch < ch_end) {
      stage_w2(ch, 0);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's W1 slice; its W2 slice may still be in flight
      __syncthreads();
      uint32_t ph[L::NZ][2];
      z_ph(ch, sW1, ph);
      cp_async_wait<0>();  // this chunk's W2 slice
      __syncthreads();     // every warp is done with sW1; the ph tile is whole
      const int nxt = next_used(ch + 1);
      if (nxt < ch_end) {
        stage_w1(nxt, 0);
        cp_async_commit();
      }
      ph_w2(sW2, ph);
      __syncthreads();  // every warp is done with sW2 and sPH
      ch = nxt;
    }
  }

  // Rows g and g + 8 of the strip, columns c, c + 1 of each output tile.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half, t = t0 + r;
    if (t >= T) continue;
#pragma unroll
    for (int n = 0; n < L::NA; ++n) {
      const int c = ac0 + n * 8 + 2 * tq;
      if (c >= C) continue;
      float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
      if (splits > 1) {  // this block's partial sum; moe_split_sum_kernel finishes the tile
        *reinterpret_cast<float2*>(ws + ((long long)split * T + t) * C + c) = make_float2(v0, v1);
      } else {  // out = bf16(acc + probs @ b2)
        for (int e2 = 0; e2 < E; ++e2) {
          const float p = sP[r * PE + e2];
          v0 = fmaf(p, b2[(long long)e2 * C + c], v0);
          v1 = fmaf(p, b2[(long long)e2 * C + c + 1], v1);
        }
        *reinterpret_cast<uint32_t*>(out + (long long)t * C + c) = pack_bf16(v0, v1);
      }
    }
  }
}

// out = bf16(sum_k ws[k] + probs @ b2) when the (expert, chunk) loop was
// split: the partials are added in split order, so the result does not
// depend on the order in which the blocks ran.
__global__ void moe_split_sum_kernel(const float* __restrict__ ws, const float* __restrict__ probs,
                                     const float* __restrict__ b2, bf16* __restrict__ out, int T,
                                     int C, int E, int splits) {
  const long long n = (long long)T * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    const long long t = i / C;
    const int c = static_cast<int>(i % C);
    for (int e = 0; e < E; ++e) s = fmaf(probs[t * E + e], b2[(long long)e * C + c], s);
    out[i] = __float2bfloat16(s);
  }
}

// The launch of moe_fwd_kernel<kRouter, CP> and, when the (expert, chunk)
// loop is split, of the split sum, which reads the routing from the
// kernel's probs output (kRouter) or from probs_in.
template <bool kRouter, int CP>
int launch_fwd(const void* x, const void* fw, const void* cw, const void* tl,
               const void* inv_temp, const void* probs_in, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, void* probs, void* ws, int T, int C,
               int Hd, int E, int F, int hard, int splits, cudaStream_t st) {
  using L = Tile<CP>;
  constexpr int smem = fwd_smem_bytes<CP>();
  static_assert(smem <= MAX_SMEM, "forward tiles exceed a block's shared memory");
  static_assert(4 * L::CW * L::BT * PE <= 2 * FC * pitch(CP), "router partials exceed the W2 slice");
  if (splits < 1 || splits > 65535 || splits > E * ((F + FC - 1) / FC) ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned attr_set = 0;
  cudaError_t err = set_smem_once(moe_fwd_kernel<kRouter, CP>, smem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + L::BT - 1) / L::BT, splits);
  moe_fwd_kernel<kRouter, CP><<<grid, L::NT, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(fw), static_cast<const float*>(cw),
      static_cast<const float*>(tl), static_cast<const float*>(inv_temp),
      static_cast<const float*>(probs_in), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), static_cast<float*>(probs),
      static_cast<float*>(ws), T, C, Hd, E, F, hard);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = (long long)T * C;
  const int blocks = static_cast<int>((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  moe_split_sum_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(kRouter ? probs : probs_in),
      static_cast<const float*>(b2), static_cast<bf16*>(out), T, C, E, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRouter>
int dispatch_fwd(const void* x, const void* fw, const void* cw, const void* tl,
                 const void* inv_temp, const void* probs_in, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, void* probs, void* ws, int T, int C,
                 int Hd, int E, int F, int hard, int splits, void* stream) {
  if (T < 1 || C % 16 != 0 || F % 16 != 0 || F < 16 || E < 1 || E > MAX_E ||
      (kRouter && (Hd < 8 || Hd % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOE_FWD(CP)                                                                            \
  launch_fwd<kRouter, CP>(x, fw, cw, tl, inv_temp, probs_in, w1, b1, w2, b2, out, probs, ws, T, \
                          C, Hd, E, F, hard, splits, st)
  switch (padded_width(C)) {
    case 32: return MOE_FWD(32);
    case 64: return MOE_FWD(64);
    case 128: return MOE_FWD(128);
    case 256: return MOE_FWD(256);
    case 512: return MOE_FWD(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MOE_FWD
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// splits from ops/fused_moe.py::moe_plan; ws: [splits, T, C] fp32 scratch,
// unused (may be null) when splits == 1. Returns the cudaError_t of the
// launches (cudaErrorInvalidValue if the widths or the splits are not
// taken).
int moegan_fused_moe_fwd(const void* x, const void* fw, const void* cw, const void* tl,
                         const void* inv_temp, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, void* probs, void* ws, int T, int C, int Hd,
                         int E, int F, int hard, int splits, void* stream) {
  return dispatch_fwd<true>(x, fw, cw, tl, inv_temp, nullptr, w1, b1, w2, b2, out, probs, ws, T,
                            C, Hd, E, F, hard, splits, stream);
}

// The expert-parallel combine (replaces _combine_kernel and _combine_kernel_v2):
// out = bf16(sum_e probs[:, e] * FFN_e(x)) over the E experts given, with the
// routing probs [T, E] fp32 read instead of computed. Same splits, scratch
// and return code as moegan_fused_moe_fwd.
int moegan_moe_combine_fwd(const void* x, const void* probs, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, void* ws, int T, int C,
                           int E, int F, int splits, void* stream) {
  return dispatch_fwd<false>(x, nullptr, nullptr, nullptr, nullptr, probs, w1, b1, w2, b2, out,
                             nullptr, ws, T, C, 0, E, F, 0, splits, stream);
}

}  // extern "C"
