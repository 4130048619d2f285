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
// On the TPU one kernel walked the q tiles of a (batch, head) in order and
// kept dk and dv resident across that walk. Hopper's blocks run in parallel
// and in no order, so the work is split three ways, with no atomics, and
// every fp32 sum runs in a fixed order (two calls give the same bits):
//
//   1. flash_bwd_delta_kernel: delta per row, one thread per row.
//   2. flash_bwd_dkdv_kernel: one block of 4 warps per (b*h, 64-key tile).
//      Each warp owns 16 keys and loops over every 64-row q tile: it
//      computes its [64 q x 16 k] strips of S and dP = do v^T on the tensor
//      cores (WMMA, bf16 in, fp32 accumulate), turns them into p and ds in
//      shared memory, and accumulates dv += p^T do and dk += ds^T q_pre in
//      register fragments. p and ds are rounded to bf16 for these products.
//   3. flash_bwd_dq_kernel: one block per (b*h, 64-row q tile); each warp
//      owns 16 query rows and loops over every 64-key tile, accumulating
//      dq += ds k in register fragments.
//
// Layout: q, k, v are [B, T, H, D] read through their strides (last one 1,
// the others multiples of 8, base 16-byte aligned), as in the forward; o and
// do are contiguous [B, T, H, D]; lse is [B, H, T] fp32; dq, dk, dv are
// written contiguous [B, T, H, D] bf16. Ragged q rows and keys past T are
// masked. D must be a multiple of 16 and at most 64.
//
// What bounds it: at the training shapes (T = 256/1024/4096, D = 16/32) the
// products (14*B*H*T^2*D FLOPs: S, dP, dV, dK in one kernel, S, dP, dQ in the
// other, against the 10*B*H*T^2*D the function needs) need little
// time at the bf16 tensor-core rate; the B*H*T^2 exponentials, twice over,
// and the shared-memory round trips of S, dP, p and ds bound this first
// version. Keeping them in registers (mma.sync fragments or wgmma) and
// sharing one recomputation between the dq and dk/dv passes are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_D = 64;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Layout {
  size_t q, dout, k, v, s, dp, p, ds, lse, delta, total;
  __host__ __device__ explicit Layout(int D) {
    size_t off = 0;
    q = off; off += align128(sizeof(bf16) * BQ * D);
    dout = off; off += align128(sizeof(bf16) * BQ * D);
    k = off; off += align128(sizeof(bf16) * BK * D);
    v = off; off += align128(sizeof(bf16) * BK * D);
    s = off; off += align128(sizeof(float) * BQ * BK);
    dp = off; off += align128(sizeof(float) * BQ * BK);
    p = off; off += align128(sizeof(bf16) * BQ * BK);
    ds = off; off += align128(sizeof(bf16) * BQ * BK);
    lse = off; off += align128(sizeof(float) * BQ);
    delta = off; off += align128(sizeof(float) * BQ);
    total = off;
  }
};

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

// Copy a [rows, D] tile starting at sequence position t0 into shared memory
// in 16-byte loads, zero-filling rows at or past T.
__device__ inline void load_tile(bf16* dst, const bf16* base, long long st, int t0, int rows,
                                 int T, int D) {
  const int per_row = D / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += NTHREADS) {
    const int r = i / per_row, c8 = i % per_row;
    const int t = t0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T) val = *reinterpret_cast<const uint4*>(base + t * st + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * D + c8 * 8) = val;
  }
}

// The q tile (scaled to q_pre in bf16), the do tile, and each row's lse and
// delta; rows past T get lse = +inf, so their p is exactly 0.
__device__ inline void load_q_side(bf16* sQ, bf16* sDO, float* sLse, float* sDelta,
                                   const bf16* qb, long long qst, const bf16* dob,
                                   const float* lse_bh, const float* delta_bh, int q0, int T,
                                   int H, int D, float scale) {
  load_tile(sQ, qb, qst, q0, BQ, T, D);
  load_tile(sDO, dob, (long long)H * D, q0, BQ, T, D);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const int t = q0 + r;
    sLse[r] = t < T ? lse_bh[t] : INFINITY;
    sDelta[r] = t < T ? delta_bh[t] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS)
    sQ[i] = __float2bfloat16(__bfloat162float(sQ[i]) * scale);
}

// p and ds for the [rows x 16] or [16 x cols] region given by (r0, nr, c0, nc)
// of the S / dP tiles; keys at or past `nvalid` (tile-relative) get p = 0.
__device__ inline void softmax_grad(const float* sS, const float* sDP, bf16* sP, bf16* sDS,
                                    const float* sLse, const float* sDelta, int r0, int nr, int c0,
                                    int nc, int nvalid) {
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < nr * nc; i += 32) {
    const int r = r0 + i / nc, c = c0 + i % nc;
    const int at = r * BK + c;
    const float p = c < nvalid ? exp2f(sS[at] - sLse[r]) : 0.f;
    const float ds = p * (sDP[at] - sDelta[r]);
    if (sP != nullptr) sP[at] = __float2bfloat16(p);
    sDS[at] = __float2bfloat16(ds);
  }
}

// delta[(b*H + h)*T + t] = sum_d do[b,t,h,d] * o[b,t,h,d] (contiguous inputs).
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                       float* __restrict__ delta, int B, int T, int H, int D) {
  const long long rows = (long long)B * T * H;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < rows;
       i += (long long)gridDim.x * blockDim.x) {
    const bf16* orow = o + i * D;
    const bf16* grow = dout + i * D;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(__bfloat162float(grow[d]), __bfloat162float(orow[d]), s);
    const long long h = i % H, bt = i / H;
    const long long t = bt % T, b = bt / T;
    delta[(b * H + h) * T + t] = s;
  }
}

template <int ND>  // D = 16 * ND
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, Strides st,
                      float scale, float dk_scale) {
  constexpr int D = 16 * ND;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(D);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L.ds);
  float* sLse = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp * 16;  // this warp's 16 keys within the tile
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* dob = dout + ((long long)b * T * H + h) * D;
  const float* lse_bh = lse + (long long)bh * T;
  const float* delta_bh = delta + (long long)bh * T;

  load_tile(sK, k + b * st.kb + h * st.kh, st.kt, k0, BK, T, D);
  load_tile(sV, v + b * st.vb + h * st.vh, st.vt, k0, BK, T, D);

  Acc accK[ND], accV[ND];
  for (int dn = 0; dn < ND; ++dn) {
    wmma::fill_fragment(accK[dn], 0.f);
    wmma::fill_fragment(accV[dn], 0.f);
  }
  const int nvalid = min(BK, T - k0);

  for (int q0 = 0; q0 < T; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous q tile
    load_q_side(sQ, sDO, sLse, sDelta, qb, st.qt, dob, lse_bh, delta_bh, q0, T, H, D, scale);
    __syncthreads();

    // S[:, kw] = q_pre k[kw]^T and dP[:, kw] = do v[kw]^T, [64 x 16] each.
    for (int mi = 0; mi < BQ / 16; ++mi) {
      Acc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
      for (int kk = 0; kk < ND; ++kk) {
        ARow fa;
        BCol fb;
        wmma::load_matrix_sync(fa, sQ + mi * 16 * D + kk * 16, D);
        wmma::load_matrix_sync(fb, sK + kw * D + kk * 16, D);
        wmma::mma_sync(s, fa, fb, s);
        wmma::load_matrix_sync(fa, sDO + mi * 16 * D + kk * 16, D);
        wmma::load_matrix_sync(fb, sV + kw * D + kk * 16, D);
        wmma::mma_sync(dp, fa, fb, dp);
      }
      wmma::store_matrix_sync(sS + mi * 16 * BK + kw, s, BK, wmma::mem_row_major);
      wmma::store_matrix_sync(sDP + mi * 16 * BK + kw, dp, BK, wmma::mem_row_major);
    }
    __syncwarp();
    softmax_grad(sS, sDP, sP, sDS, sLse, sDelta, 0, BQ, kw, 16, nvalid);
    __syncwarp();

    // dv[kw] += p[:, kw]^T do and dk[kw] += ds[:, kw]^T q_pre.
    for (int kk = 0; kk < BQ / 16; ++kk) {
      ACol fp, fds;
      wmma::load_matrix_sync(fp, sP + kk * 16 * BK + kw, BK);
      wmma::load_matrix_sync(fds, sDS + kk * 16 * BK + kw, BK);
      for (int dn = 0; dn < ND; ++dn) {
        BRow fb;
        wmma::load_matrix_sync(fb, sDO + kk * 16 * D + dn * 16, D);
        wmma::mma_sync(accV[dn], fp, fb, accV[dn]);
        wmma::load_matrix_sync(fb, sQ + kk * 16 * D + dn * 16, D);
        wmma::mma_sync(accK[dn], fds, fb, accK[dn]);
      }
    }
  }
  __syncthreads();  // every warp has read its last strips of S

  // Each warp stages its [16 x D] results in its own rows of S and writes them.
  float* stage = sS + kw * BK;
  const int HD = H * D;
  for (int pass = 0; pass < 2; ++pass) {
    for (int dn = 0; dn < ND; ++dn)
      wmma::store_matrix_sync(stage + dn * 16, pass == 0 ? accK[dn] : accV[dn], BK,
                              wmma::mem_row_major);
    __syncwarp();
    bf16* out = pass == 0 ? dk : dv;
    const float mul = pass == 0 ? dk_scale : 1.f;
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, c = i % D;
      const int t = k0 + kw + r;
      if (t < T) out[((long long)b * T + t) * HD + h * D + c] = __float2bfloat16(stage[r * BK + c] * mul);
    }
    __syncwarp();
  }
}

template <int ND>  // D = 16 * ND
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int H, Strides st, float scale,
                    float dq_scale) {
  constexpr int D = 16 * ND;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(D);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L.ds);
  float* sLse = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp * 16;  // this warp's 16 query rows within the tile
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;

  load_q_side(sQ, sDO, sLse, sDelta, q + b * st.qb + h * st.qh, st.qt,
              dout + ((long long)b * T * H + h) * D, lse + (long long)bh * T,
              delta + (long long)bh * T, q0, T, H, D, scale);

  Acc accQ[ND];
  for (int dn = 0; dn < ND; ++dn) wmma::fill_fragment(accQ[dn], 0.f);

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // scaled q visible; every warp is done with the previous K/V tile
    load_tile(sK, kb, st.kt, k0, BK, T, D);
    load_tile(sV, vb, st.vt, k0, BK, T, D);
    __syncthreads();

    // S[qw, :] = q_pre[qw] k^T and dP[qw, :] = do[qw] v^T, [16 x 64] each.
    for (int n = 0; n < BK / 16; ++n) {
      Acc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
      for (int kk = 0; kk < ND; ++kk) {
        ARow fa;
        BCol fb;
        wmma::load_matrix_sync(fa, sQ + qw * D + kk * 16, D);
        wmma::load_matrix_sync(fb, sK + n * 16 * D + kk * 16, D);
        wmma::mma_sync(s, fa, fb, s);
        wmma::load_matrix_sync(fa, sDO + qw * D + kk * 16, D);
        wmma::load_matrix_sync(fb, sV + n * 16 * D + kk * 16, D);
        wmma::mma_sync(dp, fa, fb, dp);
      }
      wmma::store_matrix_sync(sS + qw * BK + n * 16, s, BK, wmma::mem_row_major);
      wmma::store_matrix_sync(sDP + qw * BK + n * 16, dp, BK, wmma::mem_row_major);
    }
    __syncwarp();
    softmax_grad(sS, sDP, nullptr, sDS, sLse, sDelta, qw, 16, 0, BK, min(BK, T - k0));
    __syncwarp();

    // dq[qw] += ds[qw, :] k.
    for (int kk = 0; kk < BK / 16; ++kk) {
      ARow fa;
      wmma::load_matrix_sync(fa, sDS + qw * BK + kk * 16, BK);
      for (int dn = 0; dn < ND; ++dn) {
        BRow fb;
        wmma::load_matrix_sync(fb, sK + kk * 16 * D + dn * 16, D);
        wmma::mma_sync(accQ[dn], fa, fb, accQ[dn]);
      }
    }
  }
  __syncwarp();

  float* stage = sS + qw * BK;
  for (int dn = 0; dn < ND; ++dn)
    wmma::store_matrix_sync(stage + dn * 16, accQ[dn], BK, wmma::mem_row_major);
  __syncwarp();
  const int HD = H * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    const int t = q0 + qw + r;
    if (t < T) dq[((long long)b * T + t) * HD + h * D + c] = __float2bfloat16(stage[r * BK + c] * dq_scale);
  }
}

// The dk/dv and dq kernels at head dim 16 * ND.
template <int ND>
int launch_main(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int B, int T, int H,
                const Strides& st, float scale, float dq_scale, float dk_scale, cudaStream_t s) {
  const Layout L(16 * ND);
  const int smem = static_cast<int>(L.total);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<ND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((T + BK - 1) / BK, B * H);
  flash_bwd_dkdv_kernel<ND><<<grid_k, NTHREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H,
      st, scale, dk_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<ND><<<grid_q, NTHREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), T, H, st, scale, dq_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: q (b, t, h), k (b, t, h), v (b, t, h) in elements. o and do are
// contiguous [B, T, H, D]; delta is a [B, H, T] fp32 scratch. Launches the
// three kernels on `stream`; returns the cudaError_t of the launches.
int moegan_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int B, int T, int H, int D,
                               const long long* strides, float scale, float dq_scale,
                               float dk_scale, void* stream) {
  if (D % 16 != 0 || D > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  const long long rows = (long long)B * T * H;
  const int blocks = static_cast<int>((rows + 255) / 256 < 65535 ? (rows + 255) / 256 : 65535);
  flash_bwd_delta_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      B, T, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  switch (D / 16) {
    case 1: return launch_main<1>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, scale, dq_scale, dk_scale, s);
    case 2: return launch_main<2>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, scale, dq_scale, dk_scale, s);
    case 3: return launch_main<3>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, scale, dq_scale, dk_scale, s);
    default: return launch_main<4>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, H, st, scale, dq_scale, dk_scale, s);
  }
}

}  // extern "C"
