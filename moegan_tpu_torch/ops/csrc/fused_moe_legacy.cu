// The legacy three-kernel MoE backward for Hopper (sm_90a), behind
// MOEGAN_PALLAS_MOE_BWD=3: three entry points, each computing what one TPU
// kernel of _fused_moe_bwd_pallas computes, with its rounding points, and
// reading no other's scratch:
//
//   moegan_moe_bwd_dx  replaces moegan_tpu/ops/fused_moe.py::_bwd_dx_kernel:
//       dx_ffn = sum_e bf16(dz_e) W1_e^T,  dp[t, e] = <dout_t, h_e W2_e + b2_e>
//   moegan_moe_bwd_dw2 replaces ::_bwd_dw2_kernel:
//       dW2_e = h_e^T bf16(p_e dout),      db2_e = sum_t p_e dout
//   moegan_moe_bwd_dw1 replaces ::_bwd_dw1_kernel:
//       dW1_e = x^T bf16(dz_e),            db1_e = sum_t dz_e
//
// for each token and expert: p the soft routing, z = x W1_e + b1_e (fp32),
// h = bf16(gelu(z)) (erf by Abramowitz-Stegun 7.1.26, moe_tiles.cuh's
// gelu_cdf, as the TPU kernels), dy_e = bf16(p_e dout), dh = dy_e W2_e^T and
// dz = dh gelu'(z); db2 adds p_e dout in fp32 before dy's rounding, as the
// TPU kernel sums dy before its cast. Every entry point reads the routing the
// caller hands it (the forward's, as FusedMoEFunction passes it;
// ops/fused_moe.py runs the forward kernel for it when the caller has none),
// where each TPU kernel recomputes it. (The default backward,
// fused_moe_bwd.cu, rounds p h where these round p dout, so the two backwards
// differ by bf16 rounding.) dp is computed as sum_f g h + dout . b2_e with
// g = dout W2_e^T. Every fp32 sum runs in a fixed order and no kernel uses
// atomics: two calls give the same bits.
//
// What bounds them on the H100: their products, 8 (dx: z, g, dh and dz W1^T),
// 4 (dW2: z and h^T dy) and 6 (dW1: z, dh and x^T dz) x T*C*F*E FLOPs (34.4,
// 17.2 and 25.8 GFLOP a block of the 64x64 generator at batch 64, 0.035, 0.017
// and 0.026 ms at 989 TFLOP/s), and T*E*F GELUs (one reciprocal and one ex2
// each, shared with the derivative in dx and dW1); at C = 32-64 the ~25 FP32
// instructions of each hidden unit outweigh its products. One set of tiles,
// moe_tiles.cuh's, serves the three:
//
//   - moe_legacy_token_kernel, block (token tile, split) with the fused
//     backward's warp layout (Tile<CP>): the x and dout tiles stay in shared
//     memory while the block walks its share of the (expert, 64-unit chunk)
//     loop; the weight slices are staged ahead by cp.async, double-buffered
//     up to C = 128. Per chunk, z = x W1-slice, g = dout W2-slice^T and
//     dh = dy W2-slice^T go by mma.sync into register fragments; g and dh
//     share each ldmatrix of dout and W2, dy's A fragments being dout's
//     scaled by each row's p_e and rounded to bf16 in registers. gelu_cdf
//     gives h and gelu'(z) from one ex2. For dx, the dp row sums go by quad
//     shuffles and bf16 dz is packed as the A operand of dx += dz W1^T,
//     whose [16, CP / CW] fp32 accumulator stays in registers; with fewer
//     tiles than SMs the (expert, chunk) loop is split and the partials added
//     in split order. For dW1's scratch route (C = 512) it writes bf16 dz
//     [T, E*F] and per-tile fp32 column sums of dz (db1).
//   - moe_recompute_kernel, block (expert, 64 hidden units, T range), the
//     weight gradients up to C = 256 without a [T, E*F] scratch (268 MB at
//     res 64): it keeps its units' rows of dW1^T or dW2 in registers and
//     recomputes z (for dW1 also dh and dz) per stage of tokens, bf16 dz or h
//     packed in registers as the A operand of the product over the stage.
//   - At C = 512, where a warp's [16, C] fp32 sums do not fit in registers,
//     a scratch and moe_tiles.cuh's tiled product (wgrad_gemm_tile, the fused
//     backward's) in moe_gemm_kernel: for dW1 the token kernel writes bf16
//     dz [T, E*F] (17 MB there) and the product forms dz^T x; for dW2 the
//     recompute kernel writes h [E, T, F] and dy [E, T, C] and the product
//     forms h_e^T dy_e for each expert. dW1's two routes were timed against
//     each other at every width, dW2's scratch route against a recompute in
//     two blocks of 256 output columns at C = 512 (PERF.md).
//   - moe_sum_kernel adds split, T-range and tile partials in order.
//
// C <= 512 and F multiples of 16, E at most 16; plans come from
// ops/fused_moe.py::legacy_plan and are checked here.

#include "moe_tiles.cuh"

namespace {

using namespace moe;

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

// out [n] = the sum of ws [k, n] over k < count, in order.
int sum_into(const void* ws, void* out, long long n, int count, cudaStream_t st) {
  moe_sum_kernel<<<grid_for(n), 256, 0, st>>>(static_cast<const float*>(ws),
                                              static_cast<float*>(out), n, count);
  return static_cast<int>(cudaGetLastError());
}

// --- dx and dW1's scratch route: the token kernel ----------------------------------------

// bf16(p dout) for the A fragment `a` of dout (a[0], a[2]: row g; a[1],
// a[3]: row g + 8) and the rows' p_e: each bf16 pair times its row's p in
// fp32, rounded to bf16, as the TPU kernels round dy.
__device__ __forceinline__ void scale_rows(uint32_t (&dy)[4], const uint32_t (&a)[4], float p0,
                                           float p1) {
  dy[0] = scale_bf16x2(a[0], p0);
  dy[1] = scale_bf16x2(a[1], p1);
  dy[2] = scale_bf16x2(a[2], p0);
  dy[3] = scale_bf16x2(a[3], p1);
}

// dh[N] += bf16(p_e dout) W2-slice^T and, with kG, gz[N] += dout W2-slice^T,
// for the warp's 16 rows row0.. of dout (shared, width CP, K = CP) and rows
// n0 .. n0 + 8N - 1 of the W2 slice [FC][CP]: each ldmatrix of dout and of
// W2 feeds both products. p0, p1: p_e of rows row0 + g and row0 + g + 8.
template <int CP, int N, bool kG>
__device__ __forceinline__ void mma_g_dh(float (&gz)[N][4], float (&dh)[N][4], const bf16* sDO,
                                         int row0, const bf16* w2s, int n0, float p0, float p1) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    uint32_t a[4], ady[4];
    load_a<CP>(a, sDO, row0, kk * 16);
    scale_rows(ady, a, p0, p1);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      load_bt<CP>(b, w2s, n0 + np * 16, kk * 16);
      if constexpr (kG) {
        mma(gz[2 * np], a, b[0], b[1]);
        mma(gz[2 * np + 1], a, b[2], b[3]);
      }
      mma(dh[2 * np], ady, b[0], b[1]);
      mma(dh[2 * np + 1], ady, b[2], b[3]);
    }
  }
}

// Dynamic shared memory of the token kernel at padded width CP: x and dout
// tiles, NB W1 and NB W2 slices, the [BT][PE] probabilities; for dx with
// CW > 1 the [BT][FC] dz tile and the [CW][BT][PE] dp partials, for dW1 the
// [RW][FC] db1 partials.
template <int CP, bool kDx>
constexpr int token_smem_bytes() {
  using L = Tile<CP>;
  return 2 * (2 * L::BT * pitch(CP) + L::NB * (CP * pitch(FC) + FC * pitch(CP)) +
              (kDx && L::CW > 1 ? L::BT * pitch(FC) : 0)) +
         4 * (L::BT * PE + (kDx ? L::CW * L::BT * PE : L::RW * FC));
}

// Block (token tile, split): the tile's share of the (expert, chunk) loop.
// kDx: dx and dp of the tile ([splits, T, C] and [splits, T, E] partials when
// gridDim.y > 1; dp with dout . b2 in split 0). Else (dW1's scratch route,
// CP = 512 only): bf16 dz into dz_out [T, E*F] and the tile's fp32 column
// sums of dz into part_db1 [ntiles, E*F]. The launch bound's minimum of blocks an SM sets
// the registers ptxas may take: from CP = 128, where shared memory holds at
// most two blocks, a minimum of one lets dx take 166-247 registers and run
// 4-12 % faster than with 126-185 under no stated minimum; below, four keep
// it at 128 (a minimum of one let it take 215 at CP = 32 and cost 24 %)
// (scripts/torch_moe_bench.py, H100 80GB HBM3, 700 W).
template <int CP, bool kDx>
__global__ void __launch_bounds__(Tile<CP>::NT, CP >= 128 ? 1 : 4)
moe_legacy_token_kernel(const bf16* __restrict__ x, const float* __restrict__ probs,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    const bf16* __restrict__ dout, float* __restrict__ dx, float* __restrict__ dp,
                    bf16* __restrict__ dz_out, float* __restrict__ part_db1, int T, int C, int E,
                    int F) {
  using L = Tile<CP>;
  static_assert(kDx || CP > 256, "dW1 takes the scratch route above C = 256 only");
  constexpr bool kDzTile = kDx && L::CW > 1;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // [BT][CP + 8]
  bf16* sDO = sX + L::BT * pitch(CP);        // [BT][CP + 8]
  bf16* sW1 = sDO + L::BT * pitch(CP);       // [NB][CP][FC + 8]
  bf16* sW2 = sW1 + L::NB * CP * pitch(FC);  // [NB][FC][CP + 8]
  bf16* sDZ = sW2 + L::NB * FC * pitch(CP);  // [BT][FC + 8], kDzTile
  float* sP = reinterpret_cast<float*>(sDZ + (kDzTile ? L::BT * pitch(FC) : 0));  // [BT][PE]
  float* sDP = sP + L::BT * PE;              // [CW][BT][PE], kDx
  float* sDB = sDP;                          // [RW][FC], !kDx

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
  if constexpr (kDx) {
    for (int i = tid; i < L::CW * L::BT * PE; i += L::NT) sDP[i] = 0.f;
  }
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
  // p_e of the warp's rows g and g + 8 for chunk ch.
  auto p_rows = [&](int ch, float& p0, float& p1) {
    p0 = sP[(row0 + g) * PE + ch / nfc];
    p1 = sP[(row0 + g + 8) * PE + ch / nfc];
  };

  float acc[kDx ? L::NA : 1][4];  // dx
  zero_tiles(acc);
  const int zc0 = cg * (FC / L::CW), ac0 = cg * (CP / L::CW);

  // Columns n0 .. n0 + 8N - 1 of the warp's share of chunk ch, given z, dh
  // (and with kDx g) there: dz = dh gelu'(z + b1), packed bf16 (dzp[n][0]
  // row g, [1] row g + 8). kDx: the dp partials s0, s1 += g *
  // bf16(gelu(z + b1)). Else bf16 dz into the scratch and the strip's fp32
  // column sums of dz into sDB.
  auto dz_tiles = [&](int ch, int n0, auto& gz, auto& dh, auto& z, auto& dzp, float& s0,
                      float& s1) {
    constexpr int N = sizeof(dh) / sizeof(dh[0]);
    const int e = ch / nfc, f0 = (ch % nfc) * FC;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int f = f0 + n0 + n * 8 + 2 * tq;
      const float2 bb = f < F ? *reinterpret_cast<const float2*>(b1 + (long long)e * F + f)
                              : make_float2(0.f, 0.f);
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float zz = z[n][i] + ((i & 1) ? bb.y : bb.x);
        float ez;
        const float cdf = gelu_cdf(zz, ez);
        d[i] = dh[n][i] * fmaf(zz * INV_SQRT_2PI, ez, cdf);
        if constexpr (kDx) {
          const float h = round_bf16(zz * cdf);
          if (i < 2) s0 = fmaf(gz[n][i], h, s0);
          else s1 = fmaf(gz[n][i], h, s1);
        }
      }
      dzp[n][0] = pack_bf16(d[0], d[1]);
      dzp[n][1] = pack_bf16(d[2], d[3]);
      if constexpr (!kDx) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long t = t0 + row0 + g + 8 * half;
          if (t < T && f < F)
            *reinterpret_cast<uint32_t*>(dz_out + t * EF + (long long)e * F + f) = dzp[n][half];
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
    // dx only (CP <= 128). Both slices of the next chunk land while this one
    // is computed; the chunk goes in two halves of 32 columns (g and dh, z,
    // dz, then their two k-steps of dx), which keeps fewer fragments live.
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
      float p0, p1, s0 = 0.f, s1 = 0.f;
      p_rows(ch, p0, p1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float gz[NH][4], dh[NH][4], z[NH][4];
        zero_tiles(gz);
        zero_tiles(dh);
        zero_tiles(z);
        mma_g_dh<CP, NH, true>(gz, dh, sDO, row0, w2s, hf * NH * 8, p0, p1);
        mma_kn<CP / 16, NH, CP, FC>(z, sX, row0, 0, w1s, hf * NH * 8);
        uint32_t dzp[NH][2];
        dz_tiles(ch, hf * NH * 8, gz, dh, z, dzp, s0, s1);
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
    }
  } else {
    // One buffer each: the next W2 slice lands while z, dz and dx are
    // computed, the next W1 slice while g and dh are.
    if (ch < ch_end) {
      stage_w2(ch, 0);
      cp_async_commit();
      stage_w1(ch, 0);
      cp_async_commit();
    }
    for (; ch < ch_end; ++ch) {
      const bool more = ch + 1 < ch_end;
      float p0, p1, s0 = 0.f, s1 = 0.f;
      p_rows(ch, p0, p1);
      cp_async_wait<1>();  // this chunk's W2 slice; its W1 slice may still be in flight
      __syncthreads();
      float gz[kDx ? L::NZ : 1][4], dh[L::NZ][4];  // g = dout W2-slice^T, dh = dy W2-slice^T
      zero_tiles(gz);
      zero_tiles(dh);
      if constexpr (kDx) {
        mma_g_dh<CP, L::NZ, true>(gz, dh, sDO, row0, sW2, zc0, p0, p1);
      } else {
        mma_g_dh<CP, L::NZ, false>(dh, dh, sDO, row0, sW2, zc0, p0, p1);
      }
      __syncthreads();  // every warp is done with sW2
      if (more) stage_w2(ch + 1, 0);
      cp_async_commit();   // (empty when there is no next chunk: keeps the count)
      cp_async_wait<1>();  // this chunk's W1 slice
      __syncthreads();

      float z[L::NZ][4];
      zero_tiles(z);
      mma_kn<CP / 16, L::NZ, CP, FC>(z, sX, row0, 0, sW1, zc0);
      uint32_t dzp[L::NZ][2];
      dz_tiles(ch, zc0, gz, dh, z, dzp, s0, s1);
      if constexpr (kDx) {
#pragma unroll
        for (int n = 0; n < L::NZ; ++n) {
          *reinterpret_cast<uint32_t*>(sDZ + (row0 + g) * pitch(FC) + zc0 + n * 8 + 2 * tq) =
              dzp[n][0];
          *reinterpret_cast<uint32_t*>(sDZ + (row0 + g + 8) * pitch(FC) + zc0 + n * 8 + 2 * tq) =
              dzp[n][1];
        }
        flush_dp(ch, s0, s1);
        __syncthreads();  // the dz tile is whole
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
      } else {
        __syncthreads();  // sDB is whole; every warp is done with sW1
        store_db1(ch);
      }
      if (more) {
        stage_w1(ch + 1, 0);  // lands while the next g and dh run
        cp_async_commit();
      }
    }
  }

  if constexpr (kDx) {
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
  }
}

// --- the weight gradients by recompute: dW1 and dW2 up to C = 256 ------------------------
//
// Block (expert e, chunk of FW = 64 hidden units, T range s of `tchunk`
// tokens), 8 warps, tokens in stages of BTK (as fused_moe_bwd.cu's recompute
// block, whose stages are 32 tokens); its shape is moe_tiles.cuh's WTile.
// Warp (mw, kw) takes the chunk's hidden units mw * 16.. and, in each 32-token
// group of a stage, the tokens kw * 16..: z^T = W1-slice^T x^T over K = C,
// then by kind (Wg):
//   dw1: dh^T = W2-slice dy^T (dy's B fragments are dout's times each token's
//        p_e, rounded to bf16), dz = dh gelu'(z) packed bf16 as the A
//        fragment of dW1^T += dz^T x;
//   dw2: h = bf16(gelu(z)) packed as the A fragment of dW2 += h^T dy, dy's
//        B fragments read from the dout stage, which the block first scales
//        in place to bf16(p_e dout) (the tokens are the k dimension there,
//        two to a register, so the fragments cannot take one p each);
//   h:   dW2's scratch route (C = 512, where a warp's [16, C] fp32 sums do
//        not fit in registers): h into an [E, T, F] bf16 scratch, and from
//        the blocks of the first chunk the scaled dout stages into [E, T, C].
// In dw2 and h the blocks of the first chunk add the fp32 products p_e dout
// into db2 as they scale. The warp's [16, CP] fp32 sums stay in registers;
// the two token warps' sums are added in order at the end. Outputs (partials
// when gridDim.y > 1, indexed by s): wgt [E][F][C] (dW1 transposed, or dW2),
// bias [E][F] (db1) or [E][C] (db2).
enum class Wg { dw1, dw2, h };

// Tokens a stage at padded width CP (ops/fused_moe.py::_recompute_step
// mirrors it). At CP = 32 a 32-token group is a few hundred cycles of work,
// less than a stage's copy latency, and four groups a stage took dW1's res-64
// block from 0.278 to 0.240 ms; at CP = 64 they changed nothing and at 128
// two cost 7 % (scripts/torch_moe_bench.py, H100 80GB HBM3, 700 W).
template <int CP>
__host__ __device__ constexpr int recompute_step() {
  return CP == 32 ? 128 : 32;
}

// W1 slice [CP][FW], for dW1 the W2 slice [FW][CP], two stages of x and dout
// [BTK][CP] (bf16); two stages of p_e [BTK] and the db1 sums [NT] (fp32).
// The cross-warp sums [FW][CP] fp32 and db2's [NT / (CP / 8)][CP] reuse the x
// and dout stages after the last stage.
template <int CP, Wg kW>
constexpr int recompute_smem_bytes() {
  using W = WTile;
  constexpr int BTK = recompute_step<CP>();
  return 2 * (CP * pitch(W::FW) + (kW == Wg::dw1 ? W::FW * pitch(CP) : 0) +
              4 * BTK * pitch(CP)) +
         4 * (2 * BTK + W::NT);
}

// dy = bf16(p_e dout) in place over a staged [BTK][CP] dout tile, p_e [BTK]
// beside it; with `add`, the fp32 products into each thread's 8 column sums
// (its columns stay the same: NT is a multiple of a row's 16-byte segments).
template <int BTK, int CP, int NT>
__device__ __forceinline__ void scale_stage(bf16* ds, const float* pes, float (&sums)[8],
                                            bool add) {
  constexpr int PER = CP / 8;
  static_assert(NT % PER == 0, "a thread keeps its columns");
  for (int i = threadIdx.x; i < BTK * PER; i += NT) {
    const int r = i / PER, c = (i % PER) * 8;
    uint4* at = reinterpret_cast<uint4*>(ds + r * pitch(CP) + c);
    uint4 v = *at;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
    const float p = pes[r];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = unpack_bf16(w[k]);
      const float lo = f.x * p, hi = f.y * p;
      if (add) {
        sums[2 * k] += lo;
        sums[2 * k + 1] += hi;
      }
      w[k] = pack_bf16(lo, hi);
    }
    *at = v;
  }
}

template <int CP, Wg kW>
__global__ void __launch_bounds__(WTile::NT)
moe_recompute_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                     const float* __restrict__ probs, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     float* __restrict__ wgt, float* __restrict__ bias, bf16* __restrict__ hs,
                     bf16* __restrict__ dys, int T, int C, int E, int F, int tchunk) {
  using W = WTile;
  constexpr bool kDw1 = kW == Wg::dw1, kH = kW == Wg::h;
  constexpr int BTK = recompute_step<CP>(), NSUB = BTK / (16 * W::KS), FW = W::FW, NT = W::NT;
  static_assert(kH || CP <= 256, "the recompute route keeps [16, CP] sums a warp");
  static_assert(BTK % (16 * W::KS) == 0 && BTK <= NT, "a stage is whole 32-token groups");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW1t = reinterpret_cast<bf16*>(smem);       // [CP][FW + 8]
  bf16* sW2 = sW1t + CP * pitch(FW);                // [FW][CP + 8], dW1
  bf16* sX = sW2 + (kDw1 ? FW * pitch(CP) : 0);     // [2][BTK][CP + 8]
  bf16* sDO = sX + 2 * BTK * pitch(CP);             // [2][BTK][CP + 8]
  float* sPE = reinterpret_cast<float*>(sDO + 2 * BTK * pitch(CP));  // [2][BTK]
  float* sRed = sPE + 2 * BTK;                      // [NT], the db1 sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  const int mw = warp / W::KS, kw = warp % W::KS;
  const int nfw = (F + FW - 1) / FW;
  const int e = blockIdx.x / nfw, f0 = (blockIdx.x % nfw) * FW, s = blockIdx.y;
  const int tb = s * tchunk, te = min(T, tb + tchunk);
  const int ntile = te > tb ? (te - tb + BTK - 1) / BTK : 0;
  const bool first = f0 == 0;  // dW2: this block adds db2 for its columns

  stage_tile<CP, FW, NT>(sW1t, w1 + (long long)e * C * F, F, 0, C, f0, F);
  if constexpr (kDw1) stage_tile<FW, CP, NT>(sW2, w2 + (long long)e * F * C, C, f0, F, 0, C);
  auto issue = [&](int j) {  // stage j into buffer j % 2, one commit group
    const int st = j & 1, t = tb + j * BTK;
    stage_tile<BTK, CP, NT>(sX + st * BTK * pitch(CP), x, C, t, te, 0, C);
    if (!kH || first) stage_tile<BTK, CP, NT>(sDO + st * BTK * pitch(CP), dout, C, t, te, 0, C);
    if (tid < BTK) {
      const bool ok = t + tid < te;
      cp_async4(sPE + st * BTK + tid, ok ? probs + (long long)(t + tid) * E + e : probs, ok);
    }
    cp_async_commit();
  };
  if (ntile > 0) issue(0);  // with the weight slices
  else cp_async_commit();

  // Rows fr and fr + 8 of the warp's m-tile.
  const int fr = f0 + mw * 16 + g;
  const float b1r[2] = {fr < F ? b1[(long long)e * F + fr] : 0.f,
                        fr + 8 < F ? b1[(long long)e * F + fr + 8] : 0.f};
  float db1r[2] = {0.f, 0.f};
  float db2c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // this thread's db2 columns
  float a1[kH ? 1 : CP / 8][4];  // dW1^T or dW2 [16, CP] of the warp
  zero_tiles(a1);
  for (int j = 0; j < ntile; ++j) {
    cp_async_wait_all();
    __syncthreads();  // stage j landed; every warp is done with stage j - 1
    if (j + 1 < ntile) issue(j + 1);
    const bf16* xs = sX + (j & 1) * BTK * pitch(CP);
    bf16* ds = sDO + (j & 1) * BTK * pitch(CP);
    const float* pes = sPE + (j & 1) * BTK;
    if constexpr (!kDw1) {
      if (!kH || first) scale_stage<BTK, CP, NT>(ds, pes, db2c, first);
      if (kH && first) {
        // this stage's dy rows into the [E, T, C] scratch, each thread the
        // segments it scaled
        for (int i = tid; i < BTK * (CP / 8); i += NT) {
          const int r = i / (CP / 8), c = (i % (CP / 8)) * 8, t = tb + j * BTK + r;
          if (t < te && c < C)
            *reinterpret_cast<uint4*>(dys + ((long long)e * T + t) * C + c) =
                *reinterpret_cast<const uint4*>(ds + r * pitch(CP) + c);
        }
      }
      __syncthreads();  // dy is whole
    }
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      const int tw = sub * 16 * W::KS + kw * 16;  // the warp's 16 tokens of this group
      // z^T (and for dW1 dh^T) of the warp's 16 hidden units and 16 tokens, K = C.
      float zq[2][4], dq[kDw1 ? 2 : 1][4];
      zero_tiles(zq);
      zero_tiles(dq);
      // dW1: B fragments b[0], b[1] hold token tw + g, b[2], b[3] token tw + 8 + g.
      const float p0 = kDw1 ? pes[tw + g] : 0.f, p1 = kDw1 ? pes[tw + 8 + g] : 0.f;
#pragma unroll
      for (int kk = 0; kk < CP / 16; ++kk) {
        uint32_t aw[4], b[4];
        load_at<FW>(aw, sW1t, mw * 16, kk * 16);
        load_bt<CP>(b, xs, tw, kk * 16);
        mma(zq[0], aw, b[0], b[1]);
        mma(zq[1], aw, b[2], b[3]);
        if constexpr (kDw1) {
          load_a<CP>(aw, sW2, mw * 16, kk * 16);
          load_bt<CP>(b, ds, tw, kk * 16);
          mma(dq[0], aw, scale_bf16x2(b[0], p0), scale_bf16x2(b[1], p0));
          mma(dq[1], aw, scale_bf16x2(b[2], p1), scale_bf16x2(b[3], p1));
        }
      }
      // dz (dW1) or h (dW2) in registers, packed bf16 as the A fragment of the sums.
      uint32_t pq[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float zz = zq[n][i] + b1r[i >> 1];
          float ez;
          const float cdf = gelu_cdf(zz, ez);
          if constexpr (kDw1) {
            d[i] = dq[n][i] * fmaf(zz * INV_SQRT_2PI, ez, cdf);
            db1r[i >> 1] += d[i];
          } else {
            d[i] = zz * cdf;
          }
        }
        pq[n][0] = pack_bf16(d[0], d[1]);
        pq[n][1] = pack_bf16(d[2], d[3]);
      }
      if constexpr (kH) {  // h into the [E, T, F] scratch
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = tb + j * BTK + tw + n * 8 + 2 * tq + (i & 1), f = fr + 8 * (i >> 1);
            const uint32_t v = pq[n][i >> 1] >> (16 * (i & 1));
            if (t < te && f < F)
              *reinterpret_cast<uint16_t*>(hs + ((long long)e * T + t) * F + f) =
                  static_cast<uint16_t>(v);
          }
      } else {
        uint32_t a[4];
        packed_a(a, pq, 0);
        // dW1^T += bf16(dz)^T x, or dW2 += h^T bf16(p_e dout), over the warp's tokens.
        const bf16* bs = kDw1 ? xs : ds;
#pragma unroll
        for (int np = 0; np < CP / 16; ++np) {
          uint32_t b[4];
          load_b<CP>(b, bs, tw, np * 16);
          mma(a1[2 * np], a, b[0], b[1]);
          mma(a1[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the last stage

  float* sAcc = reinterpret_cast<float*>(sX);
  if constexpr (!kH) {
    // The token groups' sums meet in [FW][CP] fp32 over the token stages,
    // added in warp order; warp kw == 0 of each m-tile writes them.
    static_assert(FW * CP * 4 <= 8 * BTK * pitch(CP), "cross-warp sums exceed the stages");
    for (int k = 1; k < W::KS; ++k) {
      if (kw == k) {
#pragma unroll
        for (int n = 0; n < CP / 8; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(sAcc + (mw * 16 + g + 8 * half) * CP + n * 8 + 2 * tq) =
                make_float2(a1[n][2 * half], a1[n][2 * half + 1]);
      }
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int n = 0; n < CP / 8; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 v = *reinterpret_cast<const float2*>(
                sAcc + (mw * 16 + g + 8 * half) * CP + n * 8 + 2 * tq);
            a1[n][2 * half] += v.x;
            a1[n][2 * half + 1] += v.y;
          }
      }
      __syncthreads();
    }
    if (kw == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = fr + 8 * half;
        if (f >= F) continue;
#pragma unroll
        for (int n = 0; n < CP / 8; ++n) {
          const int c = n * 8 + 2 * tq;
          if (c >= C) continue;
          const long long at = s * (long long)E * F * C + ((long long)e * F + f) * C + c;
          *reinterpret_cast<float2*>(wgt + at) = make_float2(a1[n][2 * half], a1[n][2 * half + 1]);
        }
      }
    }
  }

  if constexpr (kDw1) {
    // db1: each warp's quad sums, added over the token groups in order.
    wtile_unit_sums(db1r, sRed, bias + (long long)s * E * F + (long long)e * F, f0, F);
  } else if (first) {
    // db2: each thread's column sums, added over the threads that share the
    // columns in order.
    constexpr int PER = CP / 8, RG = NT / PER;
    static_assert(RG * CP <= 2 * BTK * pitch(CP), "db2's sums exceed the stages");
#pragma unroll
    for (int k = 0; k < 8; ++k) sAcc[(tid / PER) * CP + (tid % PER) * 8 + k] = db2c[k];
    __syncthreads();
    for (int c = tid; c < C; c += NT) {
      float sum = 0.f;
      for (int r = 0; r < RG; ++r) sum += sAcc[r * CP + c];
      bias[(long long)s * E * C + (long long)e * C + c] = sum;
    }
  }
}

// A scratch route's tiled product: out[s][z] = A_z[T range s]^T B_z[T range s]
// for the z-th of gridDim.z pairs, A_z = A + z * a_step [T, M] and B_z = B +
// z * b_step [T, N] bf16, out fp32 [gridDim.y][gridDim.z][M][N]. Block (m-tile,
// n-tile; s; z) forms one [GBM, GBN] tile by moe_tiles.cuh's wgrad_gemm_tile.
// dW1 at C = 512: one pair, dz [T, E*F] and x (dW1 transposed).
__global__ void __launch_bounds__(256)
moe_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out,
                int T, int M, int N, long long a_step, long long b_step, int tchunk) {
  const int s = blockIdx.y, z = blockIdx.z, tb = s * tchunk;
  wgrad_gemm_tile(A + z * a_step, B + z * b_step,
                  out + ((long long)s * gridDim.z + z) * M * N, M, N, tb, min(T, tb + tchunk));
}

// The splits a token kernel may take: plan[0] its tile, plan[1] its splits.
template <int CP>
bool token_plan_ok(const int* plan, int E, int F) {
  const int nch = E * ((F + FC - 1) / FC);
  return plan[0] == Tile<CP>::BT && plan[1] >= 1 && plan[1] <= 65535 && plan[1] <= nch;
}

// T ranges plan[2] of plan[3] tokens each, whole steps of `step` tokens,
// covering T exactly once.
bool ranges_ok(const int* plan, int T, int step) {
  const int tsplits = plan[2], tchunk = plan[3];
  return tsplits >= 1 && tsplits <= 65535 && tchunk >= 1 && tchunk % step == 0 &&
         (long long)tsplits * tchunk >= T && (long long)(tsplits - 1) * tchunk < T;
}

template <int CP, bool kDx>
cudaError_t launch_token(const void* x, const void* probs, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* dout, float* dx, float* dp,
                         void* dz, float* part_db1, int T, int C, int E, int F, int splits,
                         cudaStream_t st) {
  using L = Tile<CP>;
  constexpr int smem = token_smem_bytes<CP, kDx>();
  static_assert(smem <= MAX_SMEM, "token-kernel tiles exceed a block's shared memory");
  static unsigned attr = 0;
  cudaError_t err = set_smem_once(moe_legacy_token_kernel<CP, kDx>, smem, attr);
  if (err != cudaSuccess) return err;
  moe_legacy_token_kernel<CP, kDx><<<dim3((T + L::BT - 1) / L::BT, splits), L::NT, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(probs), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(dout), dx, dp, static_cast<bf16*>(dz), part_db1, T, C, E, F);
  return cudaGetLastError();
}

template <int CP, Wg kW>
cudaError_t launch_recompute(const void* x, const void* dout, const void* probs, const void* w1,
                             const void* b1, const void* w2, float* wgt, float* bias, void* hs,
                             void* dys, int T, int C, int E, int F, const int* plan,
                             cudaStream_t st) {
  constexpr int smem = recompute_smem_bytes<CP, kW>();
  static_assert(smem <= MAX_SMEM, "recompute tiles exceed a block's shared memory");
  static unsigned attr = 0;
  cudaError_t err = set_smem_once(moe_recompute_kernel<CP, kW>, smem, attr);
  if (err != cudaSuccess) return err;
  const int blocks = E * ((F + WTile::FW - 1) / WTile::FW);
  moe_recompute_kernel<CP, kW><<<dim3(blocks, plan[2]), WTile::NT, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dout),
      static_cast<const float*>(probs), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), wgt, bias,
      static_cast<bf16*>(hs), static_cast<bf16*>(dys), T, C, E, F, plan[3]);
  return cudaGetLastError();
}

// dx: plan = (token tile, splits).
template <int CP>
int launch_dx(const void* x, const void* probs, const void* w1, const void* b1, const void* w2,
              const void* b2, const void* dout, void* ws_dx, void* ws_dp, void* dx, void* dp,
              int T, int C, int E, int F, const int* plan, cudaStream_t st) {
  const int splits = plan[1];
  if (!token_plan_ok<CP>(plan, E, F) || (splits > 1 && (ws_dx == nullptr || ws_dp == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_token<CP, true>(
      x, probs, w1, b1, w2, b2, dout, static_cast<float*>(splits > 1 ? ws_dx : dx),
      static_cast<float*>(splits > 1 ? ws_dp : dp), nullptr, nullptr, T, C, E, F, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  int rc = sum_into(ws_dx, dx, (long long)T * C, splits, st);
  return rc ? rc : sum_into(ws_dp, dp, (long long)T * E, splits, st);
}

// dW1: plan = (token tile, splits, T ranges, tokens a range, scratch route),
// the route being the scratch one exactly when CP > 256.
template <int CP>
int launch_dw1(const void* x, const void* probs, const void* w1, const void* b1, const void* w2,
               const void* dout, void* dz, void* ws_db1, void* ws_w, void* dw1t, void* db1,
               int T, int C, int E, int F, const int* plan, cudaStream_t st) {
  constexpr bool kScratch = CP > 256;
  const int tsplits = plan[2];
  const int ntiles = (T + Tile<CP>::BT - 1) / Tile<CP>::BT;
  const int nbias = kScratch ? ntiles : tsplits;  // the db1 partials: per tile or per T range
  if (!token_plan_ok<CP>(plan, E, F) || plan[4] != int(kScratch) ||
      (!kScratch && plan[1] != 1) || !ranges_ok(plan, T, kScratch ? GBK : recompute_step<CP>()) ||
      (kScratch && dz == nullptr) || (tsplits > 1 && ws_w == nullptr) ||
      (nbias > 1 && ws_db1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w_dst = static_cast<float*>(tsplits > 1 ? ws_w : dw1t);
  float* b_dst = static_cast<float*>(nbias > 1 ? ws_db1 : db1);
  cudaError_t err;
  if constexpr (kScratch) {
    err = launch_token<CP, false>(x, probs, w1, b1, w2, nullptr, dout, nullptr, nullptr, dz,
                                  b_dst, T, C, E, F, plan[1], st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int M = E * F, tiles = ((M + GBM - 1) / GBM) * ((C + GBN - 1) / GBN);
    moe_gemm_kernel<<<dim3(tiles, tsplits, 1), 256, 0, st>>>(
        static_cast<const bf16*>(dz), static_cast<const bf16*>(x), w_dst, T, M, C, 0, 0, plan[3]);
    err = cudaGetLastError();
  } else {
    err = launch_recompute<CP, Wg::dw1>(x, dout, probs, w1, b1, w2, w_dst, b_dst, nullptr,
                                        nullptr, T, C, E, F, plan, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = 0;
  if (tsplits > 1) rc = sum_into(ws_w, dw1t, (long long)E * F * C, tsplits, st);
  if (!rc && nbias > 1) rc = sum_into(ws_db1, db1, (long long)E * F, nbias, st);
  return rc;
}

// dW2: plan = (token tile, 1, T ranges, tokens a range, scratch route), the
// route being the scratch one exactly when CP > 256.
template <int CP>
int launch_dw2(const void* x, const void* probs, const void* w1, const void* b1, const void* dout,
               void* h, void* dy, void* ws_db2, void* ws_w, void* dw2, void* db2, int T, int C,
               int E, int F, const int* plan, cudaStream_t st) {
  constexpr bool kScratch = CP > 256;
  const int tsplits = plan[2];
  if (plan[0] != Tile<CP>::BT || plan[1] != 1 || plan[4] != int(kScratch) ||
      !ranges_ok(plan, T, kScratch ? GBK : recompute_step<CP>()) ||
      (kScratch && (h == nullptr || dy == nullptr)) ||
      (tsplits > 1 && (ws_w == nullptr || ws_db2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w_dst = static_cast<float*>(tsplits > 1 ? ws_w : dw2);
  float* b_dst = static_cast<float*>(tsplits > 1 ? ws_db2 : db2);
  cudaError_t err;
  if constexpr (kScratch) {
    err = launch_recompute<CP, Wg::h>(x, dout, probs, w1, b1, nullptr, nullptr, b_dst, h, dy, T,
                                      C, E, F, plan, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    // dW2_e = h_e^T dy_e, one expert a grid layer
    const int tiles = ((F + GBM - 1) / GBM) * ((C + GBN - 1) / GBN);
    moe_gemm_kernel<<<dim3(tiles, tsplits, E), 256, 0, st>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(dy), w_dst, T, F, C,
        (long long)T * F, (long long)T * C, plan[3]);
    err = cudaGetLastError();
  } else {
    err = launch_recompute<CP, Wg::dw2>(x, dout, probs, w1, b1, nullptr, w_dst, b_dst, nullptr,
                                        nullptr, T, C, E, F, plan, st);
  }
  if (err != cudaSuccess || tsplits == 1) return static_cast<int>(err);
  int rc = sum_into(ws_w, dw2, (long long)E * F * C, tsplits, st);
  return rc ? rc : sum_into(ws_db2, db2, (long long)E * C, tsplits, st);
}

bool widths_ok(int T, int C, int E, int F) {
  return T >= 1 && C >= 16 && C % 16 == 0 && F % 16 == 0 && F >= 16 && E >= 1 && E <= MAX_E &&
         padded_width(C) != 0;
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define MOE_BY_WIDTH(LAUNCH)              \
  switch (padded_width(C)) {              \
    case 32: return LAUNCH(32);           \
    case 64: return LAUNCH(64);           \
    case 128: return LAUNCH(128);         \
    case 256: return LAUNCH(256);         \
    default: return LAUNCH(512);          \
  }

// dx_ffn [T, C] and dp [T, E], fp32 (replaces _bwd_dx_kernel), given the
// soft routing probs [T, E] fp32. plan: (token tile, splits) from
// ops/fused_moe.py::legacy_plan; ws_dx [splits, T, C] and ws_dp [splits, T,
// E] fp32 scratch when splits > 1 (else null).
int moegan_moe_bwd_dx(const void* x, const void* probs, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* dout, void* ws_dx, void* ws_dp,
                      void* dx, void* dp, int T, int C, int E, int F, const int* plan,
                      void* stream) {
  if (!widths_ok(T, C, E, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOE_DX(CP) \
  launch_dx<CP>(x, probs, w1, b1, w2, b2, dout, ws_dx, ws_dp, dx, dp, T, C, E, F, plan, st)
  MOE_BY_WIDTH(MOE_DX)
#undef MOE_DX
}

// dW2 [E, F, C] and db2 [E, C], fp32 (replaces _bwd_dw2_kernel), given the
// soft routing probs [T, E] fp32. plan: (token tile, 1, T ranges, tokens a
// range, scratch route) from ops/fused_moe.py::legacy_plan. Scratch (null
// where the plan does not use it): on the scratch route h [E, T, F] and dy
// [E, T, C] bf16; ws_db2 [plan[2], E*C] and ws_w [plan[2], E*F*C] fp32 when
// plan[2] > 1.
int moegan_moe_bwd_dw2(const void* x, const void* probs, const void* w1, const void* b1,
                       const void* dout, void* h, void* dy, void* ws_db2, void* ws_w, void* dw2,
                       void* db2, int T, int C, int E, int F, const int* plan, void* stream) {
  if (!widths_ok(T, C, E, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOE_DW2(CP) \
  launch_dw2<CP>(x, probs, w1, b1, dout, h, dy, ws_db2, ws_w, dw2, db2, T, C, E, F, plan, st)
  MOE_BY_WIDTH(MOE_DW2)
#undef MOE_DW2
}

// dW1 transposed, dw1t [E, F, C], and db1 [E, F], fp32 (replaces
// _bwd_dw1_kernel), given the soft routing probs [T, E] fp32. plan: (token
// tile, splits, T ranges, tokens a range, scratch route: C > 256) from
// ops/fused_moe.py::legacy_plan. Scratch (null where the plan does not use
// it): on the scratch route dz [T, E*F] bf16 and ws_db1 [ceil(T / plan[0]),
// E*F] fp32; on the recompute route ws_db1 [plan[2], E*F] when plan[2] > 1;
// ws_w [plan[2], E*F*C] fp32 when plan[2] > 1.
int moegan_moe_bwd_dw1(const void* x, const void* probs, const void* w1, const void* b1,
                       const void* w2, const void* dout, void* dz, void* ws_db1, void* ws_w,
                       void* dw1t, void* db1, int T, int C, int E, int F, const int* plan,
                       void* stream) {
  if (!widths_ok(T, C, E, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOE_DW1(CP) \
  launch_dw1<CP>(x, probs, w1, b1, w2, dout, dz, ws_db1, ws_w, dw1t, db1, T, C, E, F, plan, st)
  MOE_BY_WIDTH(MOE_DW1)
#undef MOE_DW1
}

#undef MOE_BY_WIDTH

}  // extern "C"
