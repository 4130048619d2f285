// Flash-attention backward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel moegan_tpu/ops/flash_attention.py::_bwd_fused_kernel
// (launched by _flash_backward). It differentiates the forward of
// flash_attention.cu: q pre-scaled to q_pre = bf16(q * scale) with
// scale = bf16(log2(e)/sqrt(D)), base-2 scores s = q_pre k^T, and the saved
// base-2 logsumexp lse per row. With p = exp2(s - lse), delta = rowsum(do*o):
//
//   ds = p * (do v^T - delta)          (gradient of the natural-log logits)
//   dq = ds k * scale * ln2            (through the pre-scale; ~ 1/sqrt(D))
//   dk = ds^T q_pre * ln2
//   dv = p^T do
//
// p and ds are rounded to bf16 before their products (ds from the fp32 p),
// and the outputs to bf16.
//
// On the TPU one kernel walked the q tiles of a (batch, head) in order and
// kept dk and dv resident across that walk. Hopper's blocks run in parallel
// and in no order, so the work is split three ways, with no atomics, and
// every fp32 sum runs in a fixed order (two calls give the same bits):
//
//   1. flash_bwd_prep_kernel: delta per row and q_pre, a contiguous bf16
//      copy of the pre-scaled q that the other two read. One warp takes a
//      group of 32 / (D/8) rows in 16-byte loads of o, do and q; the row's
//      lanes sum their partial dot products in lane order.
//   2. flash_bwd_dkdv_kernel, KV-tile-major: one block of 4 warps per
//      (b*h, 64 keys); each warp owns 16 keys and walks every 64-row q tile,
//      32 q rows at a time, computing the transposed tiles as
//      FlashAttention-2 does, so that every operand is already in the A
//      layout:
//        S^T = K q_pre^T and dP^T = V do^T (mma.sync into registers),
//        P^T = exp2(S^T - lse) and dS^T = P^T (dP^T - delta) in registers,
//        packed to bf16x2, then dV += P^T do and dK += dS^T q_pre with P^T
//        and dS^T as the A operands (do and q_pre through ldmatrix.trans);
//      dK and dV stay in registers. The q_pre, do, lse and delta tiles are
//      double-buffered with cp.async.
//   3. flash_bwd_dq_kernel, q-tile-major: one block of 4 warps per
//      (b*h, 64 q rows); each warp keeps its q_pre and do fragments in
//      registers, walks every 64-key tile (K and V double-buffered with
//      cp.async) 32 keys at a time, forms S and dP in registers, and uses
//      dS as the A operand of dQ += dS K (K through ldmatrix.trans).
// No fp32 S, P, dP or dS tile lives in shared memory. Shared rows are
// padded to D + 8 so ldmatrix has no bank conflicts; each result is staged
// through the warp's own shared rows for 16-byte stores.
//
// Layout: q, k, v are [B, T, H, D] read through their strides (last one 1,
// the others multiples of 8, base 16-byte aligned), as in the forward; o and
// do are contiguous [B, T, H, D]; lse is [B, H, T] fp32; dq, dk, dv are
// written contiguous [B, T, H, D] bf16. Ragged q rows and keys past T are
// masked. D is 16, 32, 48 or 64.
//
// What bounds it: at the training shapes (T = 256 / 1024 / 4096, D = 16 /
// 32) the products are 14*B*H*T^2*D FLOPs (S, dP, dV, dK in one kernel, S,
// dP, dQ in the other, against the 10*B*H*T^2*D the function needs), and S
// is exponentiated twice: 2*B*H*T^2 exponentials on the SFUs. At the
// mma.sync rate that scripts/torch_mma_ex2_rates.py measured (541-570
// TFLOP/s on an H100 80GB HBM3 at 700 W, against 989 for wgmma) the products
// take longer than the exponentials (4.0e12/s): per 16 x 64 tile at D = 32,
// 112 MMAs (~840 clocks on one SM sub-partition) against 64 ex2 (~512).
// What the design does about it: keeps every score in registers (no
// shared-memory round trip, no scalar pass), and holds the kernels to at
// most 128 registers a thread at D <= 32 (half tiles of 32 columns, four
// 4-warp blocks an SM; full 64-column tiles at ~160 registers ran ~20 %
// slower). 8-warp blocks and three cp.async stages measured slower, and K
// and V fragments kept across q tiles gained nothing.
//
// Left for later: a single recompute of S (the dq sums need an ordered
// cross-block accumulation to keep the bits fixed), wgmma with ping-pong
// warpgroups, and part of the exponentials by a polynomial on the FMA units.

#include "flash_mma.cuh"

using namespace flash;

namespace {

constexpr int NW = 4;        // warps a block
constexpr int BQI = KV_TILE;  // q rows per streamed tile of the dk/dv kernel
constexpr int SUB = 32;       // columns of S (or S^T) live in registers at a time

// Blocks an SM must hold at once, as __launch_bounds__'s second argument:
// four 4-warp blocks (at most 128 registers a thread) at D <= 32, where the
// kernels fit them without spilling; fewer at D = 48 and 64.
constexpr int min_blocks(int D) { return D <= 32 ? 4 : D == 48 ? 3 : 2; }

// Dynamic shared memory of the dk/dv kernel: the block's K and V rows, and
// two stages of (q_pre, do) tiles with their lse and delta.
constexpr int dkdv_smem_bytes(int D) {
  return 2 * 16 * NW * pitch(D) * 2 + 2 * (2 * BQI * pitch(D) * 2 + 2 * BQI * 4);
}

// Dynamic shared memory of the dq kernel: the block's q_pre and do rows, and
// two stages of (K, V) tiles.
constexpr int dq_smem_bytes(int D) {
  return 2 * 16 * NW * pitch(D) * 2 + 2 * 2 * KV_TILE * pitch(D) * 2;
}

// delta[(b*H + h)*T + t] = sum_d do[b,t,h,d] * o[b,t,h,d] and
// qp[b,t,h,:] = bf16(q[b,t,h,:] * scale), over rows i = (b*T + t)*H + h.
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout, float* __restrict__ delta,
                      bf16* __restrict__ qp, int B, int T, int H, int D, Strides st,
                      float scale) {
  const int cpr = D / 8;         // 16-byte chunks per row
  const int rpw = 32 / cpr;      // rows per warp pass
  const int lane = threadIdx.x % 32;
  const int r = lane / cpr, c = lane % cpr;
  const long long rows = (long long)B * T * H;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long i0 = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32 * rpw; i0 < rows;
       i0 += warps * rpw) {
    const long long i = i0 + r;
    const bool ok = r < rpw && i < rows;
    float part = 0.f;
    if (ok) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + i * D + c * 8);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + i * D + c * 8);
      const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
      const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack_bf16(ow[e]), g = unpack_bf16(gw[e]);
        part = fmaf(g.x, a.x, part);
        part = fmaf(g.y, a.y, part);
      }
      const long long h = i % H, bt = i / H;
      const long long t = bt % T, b = bt / T;
      uint4 qv = *reinterpret_cast<const uint4*>(q + b * st.qb + t * st.qt + h * st.qh + c * 8);
      uint32_t* qw = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
      for (int e = 0; e < 4; ++e) qw[e] = scale_bf16x2(qw[e], scale);
      *reinterpret_cast<uint4*>(qp + i * D + c * 8) = qv;
    }
    // The row's first lane adds its neighbours' partials in lane order.
    float sum = part;
    for (int e = 1; e < cpr; ++e) {
      const float x = __shfl_down_sync(0xffffffffu, part, e);
      if (c == 0) sum += x;
    }
    if (ok && c == 0) {
      const long long h = i % H, bt = i / H;
      const long long t = bt % T, b = bt / T;
      delta[(b * H + h) * T + t] = sum;
    }
  }
}

template <int ND>
__global__ void __launch_bounds__(NW * 32, min_blocks(16 * ND))
flash_bwd_dkdv_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, Strides st,
                      float dk_scale) {
  constexpr int D = 16 * ND, LD = pitch(D), BKV = 16 * NW, NT = 32 * NW;
  constexpr int NSUB = SUB / 8;  // C tiles of S^T per warp and half tile
  constexpr int STAGE = 2 * BQI * LD * 2 + 2 * BQI * 4;  // bytes of one stage
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BKV * LD;
  unsigned char* stages = smem + 2 * BKV * LD * 2;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane & 3;
  const long long HD = (long long)H * D;
  const bf16* qpb = qp + (long long)b * T * HD + h * D;
  const bf16* dob = dout + (long long)b * T * HD + h * D;
  const float* lse_bh = lse + (long long)bh * T;
  const float* delta_bh = delta + (long long)bh * T;
  const int nq = (T + BQI - 1) / BQI;

  // Stage of q tile t: q_pre tile, do tile, lse, delta for q rows 64t .. 64t + 63.
  auto issue = [&](int t) {
    const int q0 = t * BQI;
    unsigned char* base = stages + (t & 1) * STAGE;
    bf16* tQ = reinterpret_cast<bf16*>(base);
    stage_rows<D, NT>(tQ, qpb, HD, q0, BQI, T);
    stage_rows<D, NT>(tQ + BQI * LD, dob, HD, q0, BQI, T);
    float* tL = reinterpret_cast<float*>(base + 2 * BQI * LD * 2);
    for (int i = threadIdx.x; i < 2 * BQI; i += NT) {
      const int r = i % BQI, t = q0 + r;
      const float* src = i < BQI ? lse_bh : delta_bh;
      cp_async4(tL + i, t < T ? src + t : src, t < T);
    }
    cp_async_commit();
  };

  stage_rows<D, NT>(sK, k + b * st.kb + h * st.kh, st.kt, k0, BKV, T);
  stage_rows<D, NT>(sV, v + b * st.vb + h * st.vh, st.vt, k0, BKV, T);
  issue(0);  // one group with K and V

  float dk_acc[2 * ND][4], dv_acc[2 * ND][4];
#pragma unroll
  for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int j = 0; j < nq; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1's stage
    if (j + 1 < nq) issue(j + 1);
    unsigned char* base = stages + (j & 1) * STAGE;
    const bf16* tQ = reinterpret_cast<const bf16*>(base);
    const bf16* tDO = tQ + BQI * LD;
    const float* tL = reinterpret_cast<const float*>(base + 2 * BQI * LD * 2);
    const float* tD = tL + BQI;
    const int q0 = j * BQI;

    // The warp's K and V rows as A fragments, for both halves of the q tile.
    uint32_t kfr[ND][4], vfr[ND][4];
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      load_a<D>(kfr[kk], sK, warp * 16, kk * 16);
      load_a<D>(vfr[kk], sV, warp * 16, kk * 16);
    }
    const bool ragged = q0 + BQI > T;
#pragma unroll 1
    for (int c0 = 0; c0 < BQI; c0 += SUB) {
      // S^T = K q_pre^T and dP^T = V do^T for this warp's 16 keys x SUB q rows.
      float s[NSUB][4], dp[NSUB][4];
#pragma unroll
      for (int n = 0; n < NSUB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
#pragma unroll
        for (int np = 0; np < NSUB / 2; ++np) {
          uint32_t bq[4], bo[4];
          load_bt<D>(bq, tQ, c0 + np * 16, kk * 16);
          mma(s[2 * np], kfr[kk], bq[0], bq[1]);
          mma(s[2 * np + 1], kfr[kk], bq[2], bq[3]);
          load_bt<D>(bo, tDO, c0 + np * 16, kk * 16);
          mma(dp[2 * np], vfr[kk], bo[0], bo[1]);
          mma(dp[2 * np + 1], vfr[kk], bo[2], bo[3]);
        }
      }

      // P^T and dS^T: column (q row) c0 + 8n + 2tq (+1) of keys g and g + 8.
      uint32_t pt[NSUB][2], dst[NSUB][2];
#pragma unroll
      for (int n = 0; n < NSUB; ++n) {
        const int col = c0 + n * 8 + 2 * tq;
        const float2 L = *reinterpret_cast<const float2*>(tL + col);
        const float2 Dl = *reinterpret_cast<const float2*>(tD + col);
        float p0 = fast_exp2(s[n][0] - L.x), p1 = fast_exp2(s[n][1] - L.y);
        float p2 = fast_exp2(s[n][2] - L.x), p3 = fast_exp2(s[n][3] - L.y);
        if (ragged) {  // q rows past T carry no probability
          if (q0 + col >= T) p0 = p2 = 0.f;
          if (q0 + col + 1 >= T) p1 = p3 = 0.f;
        }
        pt[n][0] = pack_bf16(p0, p1);
        pt[n][1] = pack_bf16(p2, p3);
        dst[n][0] = pack_bf16(p0 * (dp[n][0] - Dl.x), p1 * (dp[n][1] - Dl.y));
        dst[n][1] = pack_bf16(p2 * (dp[n][2] - Dl.x), p3 * (dp[n][3] - Dl.y));
      }

      // dV += P^T do and dK += dS^T q_pre over these q rows, 16 at a time.
#pragma unroll
      for (int kk = 0; kk < NSUB / 2; ++kk) {
        const uint32_t pa[4] = {pt[2 * kk][0], pt[2 * kk][1], pt[2 * kk + 1][0],
                                pt[2 * kk + 1][1]};
        const uint32_t da[4] = {dst[2 * kk][0], dst[2 * kk][1], dst[2 * kk + 1][0],
                                dst[2 * kk + 1][1]};
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          uint32_t bo[4], bq[4];
          load_b<D>(bo, tDO, c0 + kk * 16, dn * 16);
          mma(dv_acc[2 * dn], pa, bo[0], bo[1]);
          mma(dv_acc[2 * dn + 1], pa, bo[2], bo[3]);
          load_b<D>(bq, tQ, c0 + kk * 16, dn * 16);
          mma(dk_acc[2 * dn], da, bq[0], bq[1]);
          mma(dk_acc[2 * dn + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  // Each warp stages its results in its own K and V rows, read by it alone.
  const int t0 = k0 + warp * 16;
  store_rows<D>(dk_acc, dk_scale, sK + warp * 16 * LD, dk, b, h, t0, T, H);
  store_rows<D>(dv_acc, 1.f, sV + warp * 16 * LD, dv, b, h, t0, T, H);
}

template <int ND>
__global__ void __launch_bounds__(NW * 32, min_blocks(16 * ND))
flash_bwd_dq_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int H, Strides st, float dq_scale) {
  constexpr int D = 16 * ND, LD = pitch(D), BQ = 16 * NW, NT = 32 * NW, BK = KV_TILE;
  constexpr int NSUB = SUB / 8;  // C tiles of S per warp and half tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BQ * LD;
  bf16* sKV = sDO + BQ * LD;  // [stage][K, V][BK][LD]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const long long HD = (long long)H * D;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const int nk = (T + BK - 1) / BK;

  auto issue = [&](int t) {  // K and V of tile t into stage t % 2, one commit group
    bf16* dst = sKV + (t & 1) * 2 * BK * LD;
    stage_rows<D, NT>(dst, kb, st.kt, t * BK, BK, T);
    stage_rows<D, NT>(dst + BK * LD, vb, st.vt, t * BK, BK, T);
    cp_async_commit();
  };
  stage_rows<D, NT>(sQ, qp + (long long)b * T * HD + h * D, HD, q0, BQ, T);
  stage_rows<D, NT>(sDO, dout + (long long)b * T * HD + h * D, HD, q0, BQ, T);
  issue(0);  // with q_pre and do

  // lse and delta of rows g and g + 8; rows past T take 0 (their dq is not written).
  const int t0 = q0 + warp * 16;
  const float* lse_bh = lse + (long long)bh * T;
  const float* delta_bh = delta + (long long)bh * T;
  const float lse0 = t0 + g < T ? lse_bh[t0 + g] : 0.f;
  const float lse1 = t0 + g + 8 < T ? lse_bh[t0 + g + 8] : 0.f;
  const float del0 = t0 + g < T ? delta_bh[t0 + g] : 0.f;
  const float del1 = t0 + g + 8 < T ? delta_bh[t0 + g + 8] : 0.f;

  uint32_t qf[ND][4], of[ND][4];
  float dq_acc[2 * ND][4];
#pragma unroll
  for (int n = 0; n < 2 * ND; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1's stage
    if (j + 1 < nk) issue(j + 1);
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        load_a<D>(qf[kk], sQ, warp * 16, kk * 16);
        load_a<D>(of[kk], sDO, warp * 16, kk * 16);
      }
    }
    const bf16* sK = sKV + (j & 1) * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;
    const int kv0 = j * BK;

    const bool ragged = kv0 + BK > T;
#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += SUB) {
      // S and dP for the warp's 16 q rows x SUB keys.
      float s[NSUB][4], dp[NSUB][4];
#pragma unroll
      for (int n = 0; n < NSUB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
#pragma unroll
        for (int np = 0; np < NSUB / 2; ++np) {
          uint32_t bk[4], bv[4];
          load_bt<D>(bk, sK, c0 + np * 16, kk * 16);
          mma(s[2 * np], qf[kk], bk[0], bk[1]);
          mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          load_bt<D>(bv, sV, c0 + np * 16, kk * 16);
          mma(dp[2 * np], of[kk], bv[0], bv[1]);
          mma(dp[2 * np + 1], of[kk], bv[2], bv[3]);
        }
      }

      // dS of rows g and g + 8, keys kv0 + c0 + 8n + 2tq (+1); keys past T
      // carry no probability.
      uint32_t ds[NSUB][2];
#pragma unroll
      for (int n = 0; n < NSUB; ++n) {
        float p0 = fast_exp2(s[n][0] - lse0), p1 = fast_exp2(s[n][1] - lse0);
        float p2 = fast_exp2(s[n][2] - lse1), p3 = fast_exp2(s[n][3] - lse1);
        if (ragged) {
          const int key = kv0 + c0 + n * 8 + 2 * tq;
          if (key >= T) p0 = p2 = 0.f;
          if (key + 1 >= T) p1 = p3 = 0.f;
        }
        ds[n][0] = pack_bf16(p0 * (dp[n][0] - del0), p1 * (dp[n][1] - del0));
        ds[n][1] = pack_bf16(p2 * (dp[n][2] - del1), p3 * (dp[n][3] - del1));
      }

      // dQ += dS K over these keys, 16 at a time.
#pragma unroll
      for (int kk = 0; kk < NSUB / 2; ++kk) {
        const uint32_t da[4] = {ds[2 * kk][0], ds[2 * kk][1], ds[2 * kk + 1][0],
                                ds[2 * kk + 1][1]};
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          uint32_t bk[4];
          load_b<D>(bk, sK, c0 + kk * 16, dn * 16);
          mma(dq_acc[2 * dn], da, bk[0], bk[1]);
          mma(dq_acc[2 * dn + 1], da, bk[2], bk[3]);
        }
      }
    }
  }

  store_rows<D>(dq_acc, dq_scale, sQ + warp * 16 * LD, dq, b, h, t0, T, H);
}

// The dk/dv and dq kernels at head dim 16 * ND.
template <int ND>
int launch_main(const void* qp, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int B, int T, int H,
                const Strides& st, float dq_scale, float dk_scale, cudaStream_t s) {
  constexpr int D = 16 * ND;
  static_assert(dkdv_smem_bytes(D) <= MAX_SMEM && dq_smem_bytes(D) <= MAX_SMEM,
                "backward tiles exceed a block's shared memory");
  static unsigned attr_kv = 0, attr_q = 0;
  cudaError_t err = set_smem_once(flash_bwd_dkdv_kernel<ND>, dkdv_smem_bytes(D), attr_kv);
  if (err == cudaSuccess) err = set_smem_once(flash_bwd_dq_kernel<ND>, dq_smem_bytes(D), attr_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + 16 * NW - 1) / (16 * NW), B * H);
  flash_bwd_dkdv_kernel<ND><<<grid, NW * 32, dkdv_smem_bytes(D), s>>>(
      static_cast<const bf16*>(qp), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H,
      st, dk_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<ND><<<grid, NW * 32, dq_smem_bytes(D), s>>>(
      static_cast<const bf16*>(qp), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), T, H, st, dq_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: q (b, t, h), k (b, t, h), v (b, t, h) in elements. o and do are
// contiguous [B, T, H, D]; delta ([B, H, T] fp32) and qp (contiguous
// [B, T, H, D] bf16) are scratch. Launches the three kernels on `stream`;
// returns the cudaError_t of the launches.
int moegan_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* qp,
                               void* dq, void* dk, void* dv, int B, int T, int H, int D,
                               const long long* strides, float scale, float dq_scale,
                               float dk_scale, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  const long long rows = (long long)B * T * H;
  const long long groups = (rows + 32 / (D / 8) - 1) / (32 / (D / 8));  // one warp each
  const long long want = (groups + 7) / 8;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  flash_bwd_prep_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), static_cast<bf16*>(qp), B, T, H, D, st, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (D) {
    case 16: return launch_main<1>(qp, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, dq_scale, dk_scale, s);
    case 32: return launch_main<2>(qp, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, dq_scale, dk_scale, s);
    case 48: return launch_main<3>(qp, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, dq_scale, dk_scale, s);
    default: return launch_main<4>(qp, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, dq_scale, dk_scale, s);
  }
}

}  // extern "C"
