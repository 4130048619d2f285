// Fused Bayesian-MoE backward for Hopper (sm_90a): the FFN and combine part
// of the gradient under soft routing.
//
// Replaces the TPU kernel moegan_tpu/ops/fused_moe.py::_fused_moe_bwd_kernel_v2
// (launched by _fused_moe_bwd_v2). It also computes what the v1 kernel
// _bwd_fused_kernel computes: the same gradient. Given x, the routing
// probabilities p [T, E] (the forward's soft routing, which its kernel
// writes), the FFN weights and the output cotangent dout [T, C], it
// recomputes z = x W1_e + b1_e and h = bf16(gelu(z)) (erf by
// Abramowitz-Stegun 7.1.26, as the TPU kernels), and returns
//
//   g       = dout W2_e^T                       [T, F] per expert
//   dp[t,e] = sum_f g*h + dout . b2_e           (the combine's cotangent)
//   dz      = g * p_e * gelu'(z)
//   dx_ffn  = sum_e bf16(dz) W1_e^T             (fp32)
//   dW1_e   = x^T bf16(dz),  db1_e = sum_t dz
//   dW2_e   = bf16(p_e h)^T dout,  db2_e = sum_t p_e dout
//
// bf16 dz and p*h are the products' operands, as the TPU kernel rounds them
// (dz.astype(cd), ph = (h*p).astype(cd)). The router chain's own backward
// (dx through the router, dfw, dcw, dtl, dinv_temp) is left to the caller,
// as the TPU path leaves it to XLA.
//
// The one entry point, moegan_moe_combine_bwd, is also the backward of the
// expert-parallel combine. It replaces the TPU kernels ::_combine_bwd_kernel
// (v1) and ::_combine_bwd_kernel_v2: there p is a rank's local expert
// columns, so dp is the whole probs gradient and dx_ffn the whole x
// gradient.
//
// What bounds it on the H100: 10*T*C*F*E tensor FLOPs (42.9 GFLOP a block of
// the 64x64 generator at batch 64, 0.043 ms at 989 TFLOP/s), T*E*F GELUs
// with their derivative (one reciprocal, one ex2 each, shared), and at
// C = 32-64 the ~25 FP32 instructions of each hidden unit. The weight
// gradients reduce over all T tokens and dx / dp over all E*F hidden units,
// so one grid cannot own both. Three launches, no atomics, every fp32 sum in
// a fixed order (two calls give the same bits):
//
//   1. moe_bwd_token_kernel, block (token tile, split) with the forward's
//      warp layout (moe_tiles.cuh): x and dout tiles stay in shared memory
//      while the block walks its share of the (expert, chunk) loop. Per
//      chunk z = x W1-slice and g = dout W2-slice^T by mma.sync into C
//      fragments; dz, h, g*h in registers (gelu and gelu' share one ex2);
//      the dp row sums by quad shuffles; bf16 dz packed as the A operand of
//      dx += dz W1-slice^T, whose [16, CP / CW] fp32 accumulator stays in
//      registers. Weight slices are staged as in the forward. It writes dx
//      and dp (+ dout . b2).
//   2. The weight gradients, by one of two routes chosen by the width
//      (scratch_route): up to C = 64 moe_wgrad_kernel recomputes z, g, dz
//      and p*h per token tile in a block that keeps dW1[:, chunk]^T and
//      dW2[chunk, :] for 64 hidden units in registers (4*T*C*F*E more FLOPs
//      and one more GELU set, instead of two [T, E*F] bf16 scratches of 268
//      MB each at res 64, batch 64, written and read back). From C = 128 the
//      token kernel also writes bf16 dz and p*h to those scratches (17-134
//      MB there) and per-tile sums of dz and p*dout, and
//      moe_wgrad_gemm_kernel forms dW1^T = dz^T x and dW2 = (p h)^T dout in
//      128 x 128 register tiles: a recompute block can keep only C x 16-64
//      hidden units of sums in registers, too few to reuse its x and dout
//      tiles well at large C. (scripts/torch_moe_bench.py on an H100 80GB
//      HBM3: the whole backward of the C = 512 / 256 / 128 blocks at batch
//      64 took 0.61 / 0.54 / 0.40 ms of device time by recompute, 0.36 /
//      0.37 / 0.39 ms by scratch.)
//   3. moe_sum_kernel adds the split partials in order (dx and dp over the
//      token kernel's splits, the weight gradients over T ranges, db1 and
//      db2 over token tiles or T ranges).
//
// The splits and T ranges come from ops/fused_moe.py::moe_bwd_plan, which
// this file checks. C <= 512 and F multiples of 16, E at most 16.

#include <algorithm>

#include "moe_tiles.cuh"

using namespace moe;

namespace {

// The route of the weight gradients at padded width CP: from C = 128 on,
// the token kernel writes bf16 dz and p*h to [T, E*F] scratches (17-134 MB
// a block of the 64x64 generator at batch 64) and moe_wgrad_gemm_kernel
// forms the products in wide tiles; below, where the scratches would take
// 0.5-1 GB, moe_wgrad_kernel recomputes them.
template <int CP>
__host__ __device__ constexpr bool scratch_route() {
  return CP >= 128;
}

// Dynamic shared memory of the token kernel at padded width CP: x and dout
// tiles, NB W1 and NB W2 slices, with CW > 1 the [BT][FC] dz tile, the
// [BT][PE] probabilities, the [CW][BT][PE] dp partials and, on the scratch
// route, the [RW][FC] db1 partials.
template <int CP>
constexpr int token_smem_bytes() {
  using L = Tile<CP>;
  return 2 * (2 * L::BT * pitch(CP) + L::NB * (CP * pitch(FC) + FC * pitch(CP)) +
              (L::CW > 1 ? L::BT * pitch(FC) : 0)) +
         4 * (L::BT * PE + L::CW * L::BT * PE + (scratch_route<CP>() ? L::RW * FC : 0));
}

template <int CP>
__global__ void __launch_bounds__(Tile<CP>::NT)
moe_bwd_token_kernel(const bf16* __restrict__ x, const float* __restrict__ probs,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ b2,
                     const bf16* __restrict__ dout, float* __restrict__ dx,
                     float* __restrict__ dp, bf16* __restrict__ dz_out, bf16* __restrict__ ph_out,
                     float* __restrict__ part_db1, float* __restrict__ part_db2, int T, int C,
                     int E, int F) {
  using L = Tile<CP>;
  constexpr bool kScratch = scratch_route<CP>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // [BT][CP + 8]
  bf16* sDO = sX + L::BT * pitch(CP);        // [BT][CP + 8]
  bf16* sW1 = sDO + L::BT * pitch(CP);       // [NB][CP][FC + 8]
  bf16* sW2 = sW1 + L::NB * CP * pitch(FC);  // [NB][FC][CP + 8]
  bf16* sDZ = sW2 + L::NB * FC * pitch(CP);  // [BT][FC + 8], CW > 1
  float* sP = reinterpret_cast<float*>(sDZ + (L::CW > 1 ? L::BT * pitch(FC) : 0));  // [BT][PE]
  float* sDP = sP + L::BT * PE;              // [CW][BT][PE]
  float* sDB = sDP + L::CW * L::BT * PE;     // [RW][FC], kScratch

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  const int row0 = (warp / L::CW) * 16, cg = warp % L::CW;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int t0 = tile * L::BT;
  const long long EF = (long long)E * F;

  stage_tile<L::BT, CP, L::NT>(sX, x, C, t0, T, 0, C);
  stage_tile<L::BT, CP, L::NT>(sDO, dout, C, t0, T, 0, C);
  cp_async_commit();
  for (int i = tid; i < L::BT * PE; i += L::NT) {
    const int r = i / PE, e = i % PE;
    sP[i] = (e < E && t0 + r < T) ? probs[(long long)(t0 + r) * E + e] : 0.f;
  }
  for (int i = tid; i < L::CW * L::BT * PE; i += L::NT) sDP[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int nfc = (F + FC - 1) / FC, nch = E * nfc;
  const int ch_end = (int)((long long)(split + 1) * nch / splits);
  auto stage_w1 = [&](int ch, int b) {
    stage_tile<CP, FC, L::NT>(sW1 + b * CP * pitch(FC), w1 + (long long)(ch / nfc) * C * F, F, 0,
                              C, (ch % nfc) * FC, F);
  };
  auto stage_w2 = [&](int ch, int b) {
    stage_tile<FC, CP, L::NT>(sW2 + b * FC * pitch(CP), w2 + (long long)(ch / nfc) * F * C, C,
                              (ch % nfc) * FC, F, 0, C);
  };

  float acc[L::NA][4];  // dx
  zero_tiles(acc);
  const int zc0 = cg * (FC / L::CW), ac0 = cg * (CP / L::CW);

  // Columns n0 .. n0 + 8N - 1 of the warp's share of chunk ch, given g and z
  // there: dz = g p_e gelu'(z + b1) packed bf16 (dzp[n][0] row g, [1] row
  // g + 8), and the dp partials s0, s1 += g * bf16(gelu(z + b1)). On the
  // scratch route also bf16 dz and p_e h into the scratches and the strip's
  // fp32 column sums of dz into sDB.
  auto dz_tiles = [&](int ch, int n0, auto& gz, auto& z, auto& dzp, float& s0, float& s1) {
    constexpr int N = sizeof(gz) / sizeof(gz[0]);
    const int e = ch / nfc, f0 = (ch % nfc) * FC;
    const float pe0 = sP[(row0 + g) * PE + e], pe1 = sP[(row0 + g + 8) * PE + e];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int f = f0 + n0 + n * 8 + 2 * tq;
      const float2 bb = f < F ? *reinterpret_cast<const float2*>(b1 + (long long)e * F + f)
                              : make_float2(0.f, 0.f);
      float d[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float zz = z[n][i] + ((i & 1) ? bb.y : bb.x);
        float ez;
        const float cdf = gelu_cdf(zz, ez);
        const float h = round_bf16(zz * cdf);
        d[i] = gz[n][i] * (i < 2 ? pe0 : pe1) * fmaf(zz * INV_SQRT_2PI, ez, cdf);
        if (i < 2) s0 = fmaf(gz[n][i], h, s0);
        else s1 = fmaf(gz[n][i], h, s1);
        hv[i] = h;
      }
      dzp[n][0] = pack_bf16(d[0], d[1]);
      dzp[n][1] = pack_bf16(d[2], d[3]);
      if constexpr (kScratch) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long t = t0 + row0 + g + 8 * half;
          const float pe = half ? pe1 : pe0;
          if (t < T && f < F) {
            *reinterpret_cast<uint32_t*>(dz_out + t * EF + (long long)e * F + f) = dzp[n][half];
            *reinterpret_cast<uint32_t*>(ph_out + t * EF + (long long)e * F + f) =
                pack_bf16(hv[2 * half] * pe, hv[2 * half + 1] * pe);
          }
        }
        float c0 = d[0] + d[2], c1 = d[1] + d[3];  // rows g and g + 8; past T dz is 0
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, o);
          c1 += __shfl_xor_sync(0xffffffffu, c1, o);
        }
        if (g == 0) {
          sDB[(row0 / 16) * FC + n0 + n * 8 + 2 * tq] = c0;
          sDB[(row0 / 16) * FC + n0 + n * 8 + 2 * tq + 1] = c1;
        }
      }
    }
  };
  // This tile's column sums of fp32 dz over chunk ch, added over the strips
  // in order (after a barrier that makes sDB whole).
  auto store_db1 = [&](int ch) {
    const int f = (ch % nfc) * FC + threadIdx.x;
    if (threadIdx.x < FC && f < F) {
      float sum = 0.f;
      for (int r = 0; r < L::RW; ++r) sum += sDB[r * FC + threadIdx.x];
      part_db1[(long long)tile * EF + (long long)(ch / nfc) * F + f] = sum;
    }
  };
  // The dp partials of chunk ch into sDP: one lane owns each (column warp,
  // row, expert) entry.
  auto flush_dp = [&](int ch, float s0, float s1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (tq == 0) {
      sDP[(cg * L::BT + row0 + g) * PE + ch / nfc] += s0;
      sDP[(cg * L::BT + row0 + g + 8) * PE + ch / nfc] += s1;
    }
  };

  int ch = (int)((long long)split * nch / splits);
  if constexpr (L::NB == 2) {
    // Both slices of the next chunk land while this one is computed; the
    // chunk goes in two halves of 32 columns (g, z, dz, then their two
    // k-steps of dx), which keeps fewer fragments live.
    constexpr int NH = L::NZ / 2;
    if (ch < ch_end) {
      stage_w1(ch, 0);
      stage_w2(ch, 0);
      cp_async_commit();
    }
    for (int b = 0; ch < ch_end; ++ch, b ^= 1) {
      cp_async_wait_all();
      __syncthreads();  // chunk ch landed; every warp is done with buffer b ^ 1
      if (ch + 1 < ch_end) {
        stage_w1(ch + 1, b ^ 1);
        stage_w2(ch + 1, b ^ 1);
        cp_async_commit();
      }
      const bf16* w1s = sW1 + b * CP * pitch(FC);
      const bf16* w2s = sW2 + b * FC * pitch(CP);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float gz[NH][4], z[NH][4];
        zero_tiles(gz);
        zero_tiles(z);
        mma_nk<CP / 16, NH, CP, CP>(gz, sDO, row0, 0, w2s, hf * NH * 8);
        mma_kn<CP / 16, NH, CP, FC>(z, sX, row0, 0, w1s, hf * NH * 8);
        uint32_t dzp[NH][2];
        dz_tiles(ch, hf * NH * 8, gz, z, dzp, s0, s1);
#pragma unroll
        for (int ks = 0; ks < NH / 2; ++ks) {  // dx += bf16(dz) W1-slice^T
          uint32_t a[4];
          packed_a(a, dzp, ks);
#pragma unroll
          for (int np = 0; np < L::NA / 2; ++np) {
            uint32_t bw[4];
            load_bt<FC>(bw, w1s, ac0 + np * 16, hf * NH * 8 + ks * 16);
            mma(acc[2 * np], a, bw[0], bw[1]);
            mma(acc[2 * np + 1], a, bw[2], bw[3]);
          }
        }
      }
      flush_dp(ch, s0, s1);
      if constexpr (kScratch) {
        __syncthreads();  // sDB is whole
        store_db1(ch);
      }
    }
  } else {
    // One buffer each: the next W2 slice lands while dz and dx are computed,
    // the next W1 slice while g is.
    if (ch < ch_end) {
      stage_w2(ch, 0);
      cp_async_commit();
      stage_w1(ch, 0);
      cp_async_commit();
    }
    for (; ch < ch_end; ++ch) {
      const bool more = ch + 1 < ch_end;
      cp_async_wait<1>();  // this chunk's W2 slice; its W1 slice may still be in flight
      __syncthreads();
      float gz[L::NZ][4];  // g = dout W2-slice^T
      zero_tiles(gz);
      mma_nk<CP / 16, L::NZ, CP, CP>(gz, sDO, row0, 0, sW2, zc0);
      __syncthreads();  // every warp is done with sW2
      if (more) stage_w2(ch + 1, 0);
      cp_async_commit();   // (empty when there is no next chunk: keeps the count)
      cp_async_wait<1>();  // this chunk's W1 slice
      __syncthreads();

      float z[L::NZ][4];
      zero_tiles(z);
      mma_kn<CP / 16, L::NZ, CP, FC>(z, sX, row0, 0, sW1, zc0);
      uint32_t dzp[L::NZ][2];
      float s0 = 0.f, s1 = 0.f;
      dz_tiles(ch, zc0, gz, z, dzp, s0, s1);
#pragma unroll
      for (int n = 0; n < L::NZ; ++n) {
        *reinterpret_cast<uint32_t*>(sDZ + (row0 + g) * pitch(FC) + zc0 + n * 8 + 2 * tq) = dzp[n][0];
        *reinterpret_cast<uint32_t*>(sDZ + (row0 + g + 8) * pitch(FC) + zc0 + n * 8 + 2 * tq) =
            dzp[n][1];
      }
      flush_dp(ch, s0, s1);
      __syncthreads();  // the dz tile (and sDB) is whole
      if constexpr (kScratch) store_db1(ch);

#pragma unroll
      for (int ks = 0; ks < FC / 16; ++ks) {  // dx += bf16(dz) W1-slice^T
        uint32_t a[4];
        load_a<FC>(a, sDZ, row0, ks * 16);
#pragma unroll
        for (int np = 0; np < L::NA / 2; ++np) {
          uint32_t bw[4];
          load_bt<FC>(bw, sW1, ac0 + np * 16, ks * 16);
          mma(acc[2 * np], a, bw[0], bw[1]);
          mma(acc[2 * np + 1], a, bw[2], bw[3]);
        }
      }
      __syncthreads();  // every warp is done with sW1 and sDZ
      if (more) {
        stage_w1(ch + 1, 0);  // lands while the next g runs
        cp_async_commit();
      }
    }
  }

  // dx: this split's partial, or the whole sum when the loop is not split.
  float* dxs = dx + (long long)split * T * C;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + row0 + g + 8 * half;
    if (t >= T) continue;
#pragma unroll
    for (int n = 0; n < L::NA; ++n) {
      const int c = ac0 + n * 8 + 2 * tq;
      if (c < C)
        *reinterpret_cast<float2*>(dxs + (long long)t * C + c) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
  __syncthreads();  // the dp partials are whole
  float* dps = dp + (long long)split * T * E;
  for (int i = tid; i < L::BT * E; i += L::NT) {
    const int r = i / E, e = i % E, t = t0 + r;
    if (t >= T) continue;
    float s = 0.f;
    for (int c = 0; c < L::CW; ++c) s += sDP[(c * L::BT + r) * PE + e];
    if (split == 0) {  // dout . b2_e, once a token
      for (int c = 0; c < C; ++c)
        s = fmaf(__bfloat162float(sDO[r * pitch(CP) + c]), b2[(long long)e * C + c], s);
    }
    dps[(long long)t * E + e] = s;
  }
  if (kScratch && split == 0) {  // this tile's sum of p * dout, for db2
    const int rows = min(L::BT, T - t0);
    for (int i = tid; i < E * C; i += L::NT) {
      const int e = i / C, c = i % C;
      float s = 0.f;
      for (int r = 0; r < rows; ++r)
        s = fmaf(sP[r * PE + e], __bfloat162float(sDO[r * pitch(CP) + c]), s);
      part_db2[(long long)tile * E * C + i] = s;
    }
  }
}

// The recompute route's weight-gradient block (CP <= 64): FW = 64 hidden
// units of one expert (4 m-tiles of 16), 8 warps, tokens in tiles of 32.
// The two warps of an m-tile split each tile's tokens: each recomputes z^T
// and g^T for its 16 tokens over the whole K = C, keeps dz and p*h in
// registers as its A fragments, and sums all C columns over its tokens (CP
// registers a thread); the two warps' sums are added in order at the end.
// Its shape is moe_tiles.cuh's WTile.

// W1 slice [CP][FW], W2 slice [FW][CP], two stages of x and dout [BTK][CP]
// (bf16); two stages of p_e [BTK] and the db1 sums [NT] (fp32). The
// cross-warp sums [FW][CP] fp32 reuse the x and dout stages after the last
// tile.
template <int CP>
constexpr int wgrad_smem_bytes() {
  using W = WTile;
  return 2 * (CP * pitch(W::FW) + W::FW * pitch(CP) + 4 * W::BTK * pitch(CP)) +
         4 * (2 * W::BTK + W::NT);
}

// Block (expert e, chunk of FW hidden units, T range s of `tchunk` tokens).
// Outputs (partials when gridDim.y > 1, indexed by s): dw1t, dw2 [E][F][C]
// (dW1 transposed), db1 [E][F] and, from the blocks of each expert's first
// chunk, db2 [E][C]. probs [T, E] is the routing.
template <int CP>
__global__ void __launch_bounds__(WTile::NT)
moe_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                 const float* __restrict__ probs, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 float* __restrict__ dw1t, float* __restrict__ dw2, float* __restrict__ db1,
                 float* __restrict__ db2, int T, int C, int E, int F, int tchunk) {
  using W = WTile;
  constexpr int BTK = W::BTK, FW = W::FW, NT = W::NT;
  static_assert(CP <= 64, "the recompute route keeps [16, CP] sums of two products a warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW1t = reinterpret_cast<bf16*>(smem);  // [CP][FW + 8]
  bf16* sW2 = sW1t + CP * pitch(FW);           // [FW][CP + 8]
  bf16* sX = sW2 + FW * pitch(CP);             // [2][BTK][CP + 8]
  bf16* sDO = sX + 2 * BTK * pitch(CP);        // [2][BTK][CP + 8]
  float* sPE = reinterpret_cast<float*>(sDO + 2 * BTK * pitch(CP));  // [2][BTK]
  float* sRed = sPE + 2 * BTK;                 // [NT], the db1 sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  const int mw = warp / W::KS, kw = warp % W::KS;
  const int nfw = (F + FW - 1) / FW;
  const int e = blockIdx.x / nfw, f0 = (blockIdx.x % nfw) * FW, s = blockIdx.y;
  const bool with_db2 = blockIdx.x % nfw == 0;
  const int tb = s * tchunk, te = min(T, tb + tchunk);
  const int ntile = te > tb ? (te - tb + BTK - 1) / BTK : 0;

  stage_tile<CP, FW, NT>(sW1t, w1 + (long long)e * C * F, F, 0, C, f0, F);
  stage_tile<FW, CP, NT>(sW2, w2 + (long long)e * F * C, C, f0, F, 0, C);
  auto issue = [&](int j) {  // token tile j into stage j % 2, one commit group
    const int st = j & 1, t = tb + j * BTK;
    stage_tile<BTK, CP, NT>(sX + st * BTK * pitch(CP), x, C, t, te, 0, C);
    stage_tile<BTK, CP, NT>(sDO + st * BTK * pitch(CP), dout, C, t, te, 0, C);
    if (tid < BTK) {
      const bool ok = t + tid < te;
      cp_async4(sPE + st * BTK + tid, ok ? probs + (long long)(t + tid) * E + e : probs, ok);
    }
    cp_async_commit();
  };
  if (ntile > 0) issue(0);  // with the weight slices
  else cp_async_commit();

  // Rows fr and fr + 8 of the warp's m-tile; its 16 tokens tw.. of each tile.
  const int fr = f0 + mw * 16 + g, tw = kw * 16;
  const float b1r[2] = {fr < F ? b1[(long long)e * F + fr] : 0.f,
                        fr + 8 < F ? b1[(long long)e * F + fr + 8] : 0.f};
  float db1r[2] = {0.f, 0.f};
  float db2r = 0.f;  // column tid of db2, with_db2
  float a1[CP / 8][4], a2[CP / 8][4];  // dW1^T and dW2 [16, CP] of the warp
  zero_tiles(a1);
  zero_tiles(a2);
  for (int j = 0; j < ntile; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < ntile) issue(j + 1);
    const bf16* xs = sX + (j & 1) * BTK * pitch(CP);
    const bf16* ds = sDO + (j & 1) * BTK * pitch(CP);
    const float* pes = sPE + (j & 1) * BTK;

    if (with_db2 && tid < C) {  // db2_e = sum_t p_e dout over the range, once an expert
      for (int t = 0; t < BTK; ++t)
        db2r = fmaf(pes[t], __bfloat162float(ds[t * pitch(CP) + tid]), db2r);
    }

    // z^T and g^T of the warp's 16 hidden units and 16 tokens, K = C.
    float zq[2][4], gq[2][4];
    zero_tiles(zq);
    zero_tiles(gq);
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      uint32_t aw[4], b[4];
      load_at<FW>(aw, sW1t, mw * 16, kk * 16);
      load_bt<CP>(b, xs, tw, kk * 16);
      mma(zq[0], aw, b[0], b[1]);
      mma(zq[1], aw, b[2], b[3]);
      load_a<CP>(aw, sW2, mw * 16, kk * 16);
      load_bt<CP>(b, ds, tw, kk * 16);
      mma(gq[0], aw, b[0], b[1]);
      mma(gq[1], aw, b[2], b[3]);
    }
    // dz and p_e h in registers, packed bf16 as the A fragments of the sums.
    uint32_t dzq[2][2], phq[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float d[4], q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float zz = zq[n][i] + b1r[i >> 1];
        const float pe = pes[tw + n * 8 + 2 * tq + (i & 1)];
        float ez;
        const float cdf = gelu_cdf(zz, ez);
        d[i] = gq[n][i] * pe * fmaf(zz * INV_SQRT_2PI, ez, cdf);
        q[i] = round_bf16(zz * cdf) * pe;
        db1r[i >> 1] += d[i];
      }
      dzq[n][0] = pack_bf16(d[0], d[1]);
      dzq[n][1] = pack_bf16(d[2], d[3]);
      phq[n][0] = pack_bf16(q[0], q[1]);
      phq[n][1] = pack_bf16(q[2], q[3]);
    }
    uint32_t adz[4], aph[4];
    packed_a(adz, dzq, 0);
    packed_a(aph, phq, 0);
    // dW1^T += bf16(dz)^T x, dW2 += bf16(p h)^T dout over the warp's tokens.
#pragma unroll
    for (int np = 0; np < CP / 16; ++np) {
      uint32_t b[4];
      load_b<CP>(b, xs, tw, np * 16);
      mma(a1[2 * np], adz, b[0], b[1]);
      mma(a1[2 * np + 1], adz, b[2], b[3]);
      load_b<CP>(b, ds, tw, np * 16);
      mma(a2[2 * np], aph, b[0], b[1]);
      mma(a2[2 * np + 1], aph, b[2], b[3]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the last tile

  // The token groups' sums meet in [FW][CP] fp32 over the token stages, added
  // in warp order; warp kw == 0 of each m-tile writes them.
  float* sAcc = reinterpret_cast<float*>(sX);
  static_assert(FW * CP * 4 <= 4 * BTK * pitch(CP) * 2, "cross-warp sums exceed the stages");
  auto add_across = [&](float (&acc)[CP / 8][4]) {
    for (int k = 1; k < W::KS; ++k) {
      if (kw == k) {
#pragma unroll
        for (int n = 0; n < CP / 8; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(sAcc + (mw * 16 + g + 8 * half) * CP + n * 8 + 2 * tq) =
                make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
      }
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int n = 0; n < CP / 8; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 v = *reinterpret_cast<const float2*>(
                sAcc + (mw * 16 + g + 8 * half) * CP + n * 8 + 2 * tq);
            acc[n][2 * half] += v.x;
            acc[n][2 * half + 1] += v.y;
          }
      }
      __syncthreads();
    }
  };
  add_across(a1);
  add_across(a2);
  const long long efc = (long long)E * F * C;
  if (kw == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = fr + 8 * half;
      if (f >= F) continue;
#pragma unroll
      for (int n = 0; n < CP / 8; ++n) {
        const int c = n * 8 + 2 * tq;
        if (c >= C) continue;
        const long long at = s * efc + ((long long)e * F + f) * C + c;
        *reinterpret_cast<float2*>(dw1t + at) = make_float2(a1[n][2 * half], a1[n][2 * half + 1]);
        *reinterpret_cast<float2*>(dw2 + at) = make_float2(a2[n][2 * half], a2[n][2 * half + 1]);
      }
    }
  }

  // db1: each warp's quad sums, added over the token groups in order.
  wtile_unit_sums(db1r, sRed, db1 + (long long)s * E * F + (long long)e * F, f0, F);
  if (with_db2 && tid < C) db2[(long long)s * E * C + (long long)e * C + tid] = db2r;
}

// The scratch route's weight gradients (CP >= 128): dW1^T = bf16(dz)^T x and
// dW2 = bf16(p h)^T dout over a T range, from A [T, M = E*F] (the token
// kernel's scratch) and B [T, N = C], both bf16. Block (m-tile, n-tile; T
// range, product) forms one [GBM, GBN] tile by moe_tiles.cuh's
// wgrad_gemm_tile.
__global__ void __launch_bounds__(256)
moe_wgrad_gemm_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ ph,
                      const bf16* __restrict__ x, const bf16* __restrict__ dout,
                      float* __restrict__ dw1t, float* __restrict__ dw2, int T, int M, int N,
                      int tchunk) {
  const int which = blockIdx.y & 1, s = blockIdx.y >> 1;
  const int tb = s * tchunk, te = min(T, tb + tchunk);
  wgrad_gemm_tile(which ? ph : dz, which ? dout : x,
                  (which ? dw2 : dw1t) + (long long)s * M * N, M, N, tb, te);
}

// dst[i] = sum_k src[k * n + i] for k < count, in order, for up to seven
// (src, dst, n, count) jobs in one launch.
struct SumJob {
  const float* src;
  float* dst;
  long long n;
  int count;
};
struct SumJobs {
  SumJob job[7];
  int njobs;
};

__global__ void moe_sum_kernel(SumJobs jobs) {
  long long total = 0;
  for (int j = 0; j < jobs.njobs; ++j) total += jobs.job[j].n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    long long k = i;
    int j = 0;
    while (k >= jobs.job[j].n) k -= jobs.job[j++].n;
    const SumJob& job = jobs.job[j];
    float s = 0.f;
    for (int c = 0; c < job.count; ++c) s += job.src[c * job.n + k];
    job.dst[k] = s;
  }
}

// The three launches at padded width CP. plan = (token tile, splits, T
// ranges, tokens a range); the token tile sizes the scratch route's db1 and
// db2 partials, so it must be this file's.
template <int CP>
int launch_bwd(const void* x, const void* probs, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* dout, void* dz, void* ph, void* ws_dx, void* ws_dp,
               void* ws_w1, void* ws_w2, void* ws_db1, void* ws_db2, void* dx, void* dp,
               void* dw1t, void* db1, void* dw2, void* db2, int T, int C, int E, int F,
               const int* plan, cudaStream_t st) {
  using L = Tile<CP>;
  constexpr bool kScratch = scratch_route<CP>();
  constexpr int tsmem = token_smem_bytes<CP>();
  static_assert(tsmem <= MAX_SMEM, "token-kernel tiles exceed a block's shared memory");
  const int splits = plan[1], tsplits = plan[2], tchunk = plan[3];
  const int nfc = (F + FC - 1) / FC, ntiles = (T + L::BT - 1) / L::BT;
  const int wtile = kScratch ? GBK : WTile::BTK;
  // the token tiles' db1 / db2 partials (scratch route) or the T ranges' (recompute)
  const int nbias = kScratch ? ntiles : tsplits;
  if (plan[0] != L::BT || splits < 1 || splits > 65535 || splits > E * nfc || tsplits < 1 ||
      2 * tsplits > 65535 || tchunk < 1 || tchunk % wtile != 0 ||
      (long long)tsplits * tchunk < T || (long long)(tsplits - 1) * tchunk >= T ||
      (splits > 1 && (ws_dx == nullptr || ws_dp == nullptr)) ||
      (tsplits > 1 && (ws_w1 == nullptr || ws_w2 == nullptr)) ||
      (nbias > 1 && (ws_db1 == nullptr || ws_db2 == nullptr)) ||
      (kScratch && (dz == nullptr || ph == nullptr || ws_db1 == nullptr || ws_db2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned token_attr = 0;
  cudaError_t err = set_smem_once(moe_bwd_token_kernel<CP>, tsmem, token_attr);
  if (err != cudaSuccess) return static_cast<int>(err);

  float* dx_dst = static_cast<float*>(splits > 1 ? ws_dx : dx);
  float* dp_dst = static_cast<float*>(splits > 1 ? ws_dp : dp);
  moe_bwd_token_kernel<CP><<<dim3(ntiles, splits), L::NT, tsmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(probs), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(dout), dx_dst, dp_dst, static_cast<bf16*>(dz),
      static_cast<bf16*>(ph), static_cast<float*>(ws_db1), static_cast<float*>(ws_db2), T, C, E,
      F);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  float* w1_dst = static_cast<float*>(tsplits > 1 ? ws_w1 : dw1t);
  float* w2_dst = static_cast<float*>(tsplits > 1 ? ws_w2 : dw2);
  if constexpr (kScratch) {
    const int M = E * F;
    const int blocks = ((M + GBM - 1) / GBM) * ((C + GBN - 1) / GBN);
    moe_wgrad_gemm_kernel<<<dim3(blocks, 2 * tsplits), 256, 0, st>>>(
        static_cast<const bf16*>(dz), static_cast<const bf16*>(ph), static_cast<const bf16*>(x),
        static_cast<const bf16*>(dout), w1_dst, w2_dst, T, M, C, tchunk);
  } else {
    constexpr int wsmem = wgrad_smem_bytes<CP>();
    static_assert(wsmem <= MAX_SMEM, "weight-gradient tiles exceed a block's shared memory");
    static unsigned wgrad_attr = 0;
    if ((err = set_smem_once(moe_wgrad_kernel<CP>, wsmem, wgrad_attr)) != cudaSuccess)
      return static_cast<int>(err);
    const int nfw = (F + WTile::FW - 1) / WTile::FW;
    moe_wgrad_kernel<CP><<<dim3(E * nfw, tsplits), WTile::NT, wsmem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dout),
        static_cast<const float*>(probs), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2), w1_dst, w2_dst,
        static_cast<float*>(tsplits > 1 ? ws_db1 : db1),
        static_cast<float*>(tsplits > 1 ? ws_db2 : db2), T, C, E, F, tchunk);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  SumJobs jobs{};
  auto add = [&](void* src, void* dst, long long n, int count) {
    jobs.job[jobs.njobs++] = SumJob{static_cast<const float*>(src), static_cast<float*>(dst), n, count};
  };
  const long long efc = (long long)E * F * C;
  if (splits > 1) {
    add(ws_dx, dx, (long long)T * C, splits);
    add(ws_dp, dp, (long long)T * E, splits);
  }
  if (tsplits > 1) {
    add(ws_w1, dw1t, efc, tsplits);
    add(ws_w2, dw2, efc, tsplits);
  }
  if (kScratch || tsplits > 1) {
    add(ws_db1, db1, (long long)E * F, nbias);
    add(ws_db2, db2, (long long)E * C, nbias);
  }
  if (jobs.njobs == 0) return 0;
  long long total = 0;
  for (int j = 0; j < jobs.njobs; ++j) total += jobs.job[j].n;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
  moe_sum_kernel<<<blocks, 256, 0, st>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward of the fused MoE (given the forward's routing) and of the
// expert-parallel combine (replaces _combine_bwd_kernel and
// _combine_bwd_kernel_v2): the gradient with the routing probs [T, E] fp32
// read. dp is the whole gradient of probs (and, for the combine, dx the
// whole gradient of x). plan: 4 ints from ops/fused_moe.py::moe_bwd_plan.
// Buffers (the wrapper allocates them from the plan; those a plan does not
// use may be null): on the scratch route (C > 64) dz and ph bf16 [T, E*F],
// ws_db1 fp32 [ntiles, E, F] and ws_db2 [ntiles, E, C]; on the recompute
// route ws_db1 and ws_db2 [tsplits, E, F] / [tsplits, E, C] when tsplits >
// 1; ws_dx fp32 [splits, T, C] and ws_dp [splits, T, E] when splits > 1;
// ws_w1, ws_w2 fp32 [tsplits, E, F, C] when tsplits > 1. Outputs, all fp32:
// dx [T, C], dp [T, E], dw1t [E, F, C] (dW1 transposed), db1 [E, F], dw2
// [E, F, C], db2 [E, C]. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue if the widths are not taken or the plan does not
// fit this file's tiles).
int moegan_moe_combine_bwd(const void* x, const void* probs, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* dout, void* dz, void* ph,
                           void* ws_dx, void* ws_dp, void* ws_w1, void* ws_w2, void* ws_db1,
                           void* ws_db2, void* dx, void* dp, void* dw1t, void* db1, void* dw2,
                           void* db2, int T, int C, int E, int F, const int* plan,
                           void* stream) {
  if (T < 1 || C % 16 != 0 || F % 16 != 0 || F < 16 || E < 1 || E > MAX_E)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOE_BWD(CP)                                                                         \
  launch_bwd<CP>(x, probs, w1, b1, w2, b2, dout, dz, ph, ws_dx, ws_dp, ws_w1, ws_w2, ws_db1, \
                 ws_db2, dx, dp, dw1t, db1, dw2, db2, T, C, E, F, plan, st)
  switch (padded_width(C)) {
    case 32: return MOE_BWD(32);
    case 64: return MOE_BWD(64);
    case 128: return MOE_BWD(128);
    case 256: return MOE_BWD(256);
    case 512: return MOE_BWD(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MOE_BWD
}

}  // extern "C"
