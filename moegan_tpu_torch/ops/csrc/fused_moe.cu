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
//   out    = sum_e bf16(p_e * bf16(gelu_erf(x @ W1_e + b1_e))) @ W2_e + probs @ b2
//
// The rounding of p_e*h to bf16 before the second product is v2's
// (fused_moe.py:759); under hard routing it is exact.
//
// The same kernel, instantiated without the router (kRouter = false), is
// the expert-parallel combine moegan_moe_combine_fwd. It replaces the TPU
// kernels ::_combine_kernel (v1) and ::_combine_kernel_v2, launched by
// moe_ffn_combine under expert parallelism:
//
//   out = sum_e bf16(p_e * bf16(gelu_erf(x @ W1_e + b1_e))) @ W2_e + probs @ b2
//
// over the E experts it is given (a rank's local shard), with probs [T, E]
// read from memory (soft, or one-hot at eval). It writes the rank's
// partial sum in bf16; the caller adds the ranks' partials. Experts that
// no token of a tile weighs are skipped, as under hard routing above.
//
// Design: block (i, s) of the grid takes token tile i (BT tokens) and the
// s-th of `splits` contiguous ranges of the (expert, F-chunk) loop, so that
// a layer with few token tiles (res 4: T/BT = 8 at batch 16) still fills the
// card. The x tile stays in shared memory; each (expert, F-chunk of width
// FC) step stages one [C, FC] slice of W1 and one [FC, C] slice of W2 with
// cp.async, so the [BT, F] activation never reaches device memory. Both
// products and the router's x @ fw run on the tensor cores through WMMA
// (bf16 in, fp32 accumulate, 16x16x16); the [BT, C] fp32 output accumulator
// lives in shared memory. Every block of a tile computes the tile's routing
// itself. Under hard routing a block skips the experts that no token of its
// tile selected (their p_e is exactly 0, so the sum is unchanged). With
// splits > 1 each block writes its partial sum to a [splits, T, C]
// workspace, and a small second kernel of the same launch adds the partials
// in split order (so the result does not depend on which block ran when)
// plus probs @ b2. BT and FC are chosen from the 227 KB of shared memory a
// block may use, `splits` from the SM count. Ragged token tiles (T not a
// multiple of BT) are masked. C and F must be multiples of 16, the router
// width a multiple of 8, E at most 16.
//
// What bounds it: at the serving shapes the FFN's FLOPs at the bf16 tensor-
// core rate and its weight bytes are both far below what this version
// reaches. It stages each weight slice synchronously (no overlap of a load
// with the previous slice's products), round-trips the output accumulator
// through shared memory at every F-chunk, and reads each expert's weights
// once per token tile; wgmma, a ring of TMA-fed stages and register-resident
// accumulators are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_E = 16;
// 227 KB of opt-in shared memory per block on H100, less room for the
// kernel's static shared variables.
constexpr size_t SMEM_LIMIT = 232448 - 1024;

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Shared-memory tiles. Each row is padded by 16 bytes so that the rows of a
// 16x16 WMMA fragment fall on different banks (the unpadded strides, 64 B
// to 2 KB, put every row of a fragment on the same banks).
struct Layout {
  int ldx, ldw1, ldw2, ldz, ldh, ldacc;
  size_t x, w1, w2, z, h, acc, lg, total;
  __host__ __device__ Layout(int BT, int FC, int C, int E) {
    ldx = C + 8;     // bf16 [BT, C]
    ldw1 = FC + 8;   // bf16 [C, FC]
    ldw2 = C + 8;    // bf16 [FC, C]
    ldz = FC + 4;    // fp32 [BT, FC]
    ldh = FC + 8;    // bf16 [BT, FC]
    ldacc = C + 4;   // fp32 [BT, C]
    size_t off = 0;
    x = off; off += align128(sizeof(bf16) * BT * ldx);
    w1 = off; off += align128(sizeof(bf16) * C * ldw1);
    w2 = off; off += align128(sizeof(bf16) * FC * ldw2);
    z = off; off += align128(sizeof(float) * BT * ldz);
    h = off; off += align128(sizeof(bf16) * BT * ldh);
    acc = off; off += align128(sizeof(float) * BT * ldacc);
    lg = off; off += align128(sizeof(float) * BT * E);
    total = off;
  }
};

// Asynchronous 16-byte copy of 8 bf16 values, global -> shared (both aligned).
__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ inline void zero16(void* dst) { *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0); }

// Cm[M, N] (+)= A[M, K] @ B[K, N]: bf16 row-major operands and an fp32
// row-major result, all in shared memory; one 16x16 output tile per warp at
// a time. M, N, K multiples of 16.
__device__ void mma_tiles(const bf16* A, int lda, const bf16* B, int ldb, float* Cm, int ldc,
                          int M, int N, int K, bool accumulate) {
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, A + mi * 16 * lda + kk * 16, lda);
      wmma::load_matrix_sync(fb, B + kk * 16 * ldb + ni * 16, ldb);
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

// kRouter: compute the routing from the router inputs (fused_moe_fwd). Without
// it the routing probabilities are read from probs_in [T, E] and the router
// arguments are unused (moe_combine_fwd); the rest of the kernel is shared.
template <bool kRouter>
__global__ void __launch_bounds__(NTHREADS)
fused_moe_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ fw,
                     const float* __restrict__ cw, const float* __restrict__ tl,
                     const float* __restrict__ inv_temp, const float* __restrict__ probs_in,
                     const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, bf16* __restrict__ out,
                     float* __restrict__ probs, float* __restrict__ ws, int T, int C, int Hd,
                     int E, int F, int BT, int FC, int hard) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_used[MAX_E];
  const Layout L(BT, FC, C, E);
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + L.w2);
  float* sZ = reinterpret_cast<float*>(smem + L.z);
  bf16* sH = reinterpret_cast<bf16*>(smem + L.h);
  float* sAcc = reinterpret_cast<float*>(smem + L.acc);
  float* sP = reinterpret_cast<float*>(smem + L.lg);  // [BT, E] logits, then probs

  const int tid = threadIdx.x;
  const int split = blockIdx.y, splits = gridDim.y;
  const int t0 = blockIdx.x * BT;
  const int rows = min(BT, T - t0);

  // x tile (rows past T are zero), zeroed accumulators.
  stage_rows(sX, L.ldx, x + (long long)t0 * C, BT, rows, C);
  for (int i = tid; i < BT * L.ldacc; i += NTHREADS) sAcc[i] = 0.f;
  for (int i = tid; i < BT * E; i += NTHREADS) sP[i] = 0.f;
  if (tid < E) s_used[tid] = (kRouter && !hard) ? 1 : 0;
  cp_async_wait_all();
  __syncthreads();

  if constexpr (!kRouter) {
    // The given probabilities; an expert that no token of the tile weighs
    // (p exactly 0, as under one-hot routing) is skipped below.
    for (int i = tid; i < rows * E; i += NTHREADS) {
      const float p = probs_in[(long long)t0 * E + i];
      sP[i] = p;
      if (p != 0.f) s_used[i % E] = 1;
    }
    __syncthreads();
  } else {
    // Router logits: (x @ fw) @ cw_f, FC hidden columns at a time; the
    // [BT, FC] slice of x @ fw goes through the W1 staging buffer and sZ.
    for (int j0 = 0; j0 < Hd; j0 += FC) {
      stage_cols(sW1, L.ldw1, fw, C, Hd, j0, FC, Hd);
      cp_async_wait_all();
      __syncthreads();
      mma_tiles(sX, L.ldx, sW1, L.ldw1, sZ, L.ldz, BT, FC, C, false);
      __syncthreads();
      for (int i = tid; i < BT * E; i += NTHREADS) {
        const int r = i / E, e = i % E;
        float s = 0.f;
        for (int jj = 0; jj < FC && j0 + jj < Hd; ++jj) s = fmaf(sZ[r * L.ldz + jj], cw[(j0 + jj) * E + e], s);
        sP[i] += s;
      }
      __syncthreads();
    }

    // Routing probabilities, one thread per token; under hard routing, mark
    // the experts that some token of the tile selected.
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
      float pmax = 0.f;
      for (int e = 0; e < E; ++e) {
        p[e] = p[e] / sum2;
        pmax = fmaxf(pmax, p[e]);
      }
      if (hard) {
        float n = 0.f;
        for (int e = 0; e < E; ++e) n += (p[e] == pmax) ? 1.f : 0.f;
        for (int e = 0; e < E; ++e) {
          p[e] = (p[e] == pmax) ? 1.f / n : 0.f;
          if (p[e] > 0.f && r < rows) s_used[e] = 1;
        }
      }
      for (int e = 0; e < E; ++e) sP[r * E + e] = p[e];
    }
    __syncthreads();
    if (split == 0) {
      for (int i = tid; i < rows * E; i += NTHREADS) probs[(long long)t0 * E + i] = sP[i];
    }
  }

  // This block's share of the (expert, F-chunk) loop.
  const int nfc = F / FC, nch = E * nfc;
  const int ch_end = (int)((long long)(split + 1) * nch / splits);
  for (int ch = (int)((long long)split * nch / splits); ch < ch_end; ++ch) {
    const int e = ch / nfc, f0 = (ch % nfc) * FC;
    if (!s_used[e]) continue;  // the same for every thread of the block
    // W1[e][:, f0:f0+FC] as [C, FC] and W2[e][f0:f0+FC, :] as [FC, C].
    stage_cols(sW1, L.ldw1, w1 + (long long)e * C * F, C, F, f0, FC, F);
    stage_rows(sW2, L.ldw2, w2 + ((long long)e * F + f0) * C, FC, FC, C);
    cp_async_wait_all();
    __syncthreads();

    mma_tiles(sX, L.ldx, sW1, L.ldw1, sZ, L.ldz, BT, FC, C, false);  // z = x @ W1 slice
    __syncthreads();

    // h = bf16(gelu_erf(z + b1)); ph = bf16(h * p_e).
    for (int i = tid; i < BT * FC; i += NTHREADS) {
      const int r = i / FC, j = i % FC;
      const float z = sZ[r * L.ldz + j] + b1[(long long)e * F + f0 + j];
      const float g = 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
      const float hv = __bfloat162float(__float2bfloat16(g));
      sH[r * L.ldh + j] = __float2bfloat16(hv * sP[r * E + e]);
    }
    __syncthreads();

    mma_tiles(sH, L.ldh, sW2, L.ldw2, sAcc, L.ldacc, BT, C, FC, true);  // acc += ph @ W2 slice
    __syncthreads();
  }

  if (splits > 1) {
    // This block's partial sum; moe_split_sum_kernel finishes the tile.
    const int c4 = C / 4;
    float4* part = reinterpret_cast<float4*>(ws + ((long long)split * T + t0) * C);
    for (int i = tid; i < rows * c4; i += NTHREADS) {
      const int r = i / c4, c = (i % c4) * 4;
      part[i] = *reinterpret_cast<const float4*>(sAcc + r * L.ldacc + c);
    }
    return;
  }
  // out = bf16(acc + probs @ b2).
  for (int i = tid; i < rows * C; i += NTHREADS) {
    const int r = i / C, c = i % C;
    float bias = 0.f;
    for (int e = 0; e < E; ++e) bias = fmaf(sP[r * E + e], b2[(long long)e * C + c], bias);
    out[(long long)t0 * C + i] = __float2bfloat16(sAcc[r * L.ldacc + c] + bias);
  }
}

// out = bf16(sum_k ws[k] + probs @ b2) when the (expert, F-chunk) loop was
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
    float bias = 0.f;
    for (int e = 0; e < E; ++e) bias = fmaf(probs[t * E + e], b2[(long long)e * C + c], bias);
    out[i] = __float2bfloat16(s + bias);
  }
}

// Largest token tile, then widest F-chunk, whose shared memory fits.
bool pick_tiles(int C, int F, int E, int* bt, int* fc) {
  const int bts[] = {64, 32, 16};
  const int fcs[] = {64, 32, 16};
  for (int b : bts) {
    for (int f : fcs) {
      if (F % f != 0) continue;
      if (Layout(b, f, C, E).total <= SMEM_LIMIT) {
        *bt = b;
        *fc = f;
        return true;
      }
    }
  }
  return false;
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan at (T, C, F, E) on a card with `sms` SMs: token tile, F-chunk
// and the number of splits of the (expert, F-chunk) loop, enough for about
// one block per SM. Returns 0 if no tile fits shared memory.
int moegan_fused_moe_plan(int T, int C, int F, int E, int sms, int* bt, int* fc, int* splits) {
  if (!pick_tiles(C, F, E, bt, fc)) return 0;
  const int ntiles = (T + *bt - 1) / *bt;
  const int nch = E * (F / *fc);
  const int s = (sms + ntiles - 1) / ntiles;
  *splits = s < 1 ? 1 : (s > nch ? nch : s);
  return 1;
}

}  // extern "C"

namespace {

// The launch of fused_moe_fwd_kernel<kRouter> and, when the (expert, F-chunk)
// loop is split, of the split sum, which reads the routing from the kernel's
// probs output (kRouter) or from probs_in.
template <bool kRouter>
int launch_fwd(const void* x, const void* fw, const void* cw, const void* tl,
               const void* inv_temp, const void* probs_in, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, void* probs, void* ws, int T, int C,
               int Hd, int E, int F, int hard, int splits, void* stream) {
  int bt = 0, fc = 0;
  if (!pick_tiles(C, F, E, &bt, &fc) || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(bt, fc, C, E);
  cudaError_t err = cudaFuncSetAttribute(fused_moe_fwd_kernel<kRouter>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((T + bt - 1) / bt, splits);
  fused_moe_fwd_kernel<kRouter><<<grid, NTHREADS, L.total, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(fw), static_cast<const float*>(cw),
      static_cast<const float*>(tl), static_cast<const float*>(inv_temp),
      static_cast<const float*>(probs_in), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), static_cast<float*>(probs),
      static_cast<float*>(ws), T, C, Hd, E, F, bt, fc, hard);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = (long long)T * C;
  const int blocks = static_cast<int>((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  moe_split_sum_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(kRouter ? probs : probs_in),
      static_cast<const float*>(b2), static_cast<bf16*>(out), T, C, E, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ws: [splits, T, C] fp32 scratch, unused (may be null) when splits == 1.
// Returns the cudaError_t of the launches (cudaErrorInvalidValue if no tile
// fits or the arguments do not match the plan).
int moegan_fused_moe_fwd(const void* x, const void* fw, const void* cw, const void* tl,
                         const void* inv_temp, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, void* probs, void* ws, int T, int C, int Hd,
                         int E, int F, int hard, int splits, void* stream) {
  return launch_fwd<true>(x, fw, cw, tl, inv_temp, nullptr, w1, b1, w2, b2, out, probs, ws, T,
                          C, Hd, E, F, hard, splits, stream);
}

// The expert-parallel combine (replaces _combine_kernel and _combine_kernel_v2):
// out = bf16(sum_e probs[:, e] * FFN_e(x)) over the E experts given, with the
// routing probs [T, E] fp32 read instead of computed. Same plan, scratch and
// return code as moegan_fused_moe_fwd.
int moegan_moe_combine_fwd(const void* x, const void* probs, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, void* ws, int T, int C,
                           int E, int F, int splits, void* stream) {
  return launch_fwd<false>(x, nullptr, nullptr, nullptr, nullptr, probs, w1, b1, w2, b2, out,
                           nullptr, ws, T, C, 0, E, F, 0, splits, stream);
}

}  // extern "C"
