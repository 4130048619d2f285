// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel moegan_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_forward), in its default form: q pre-scaled by
// log2(e)/sqrt(D) in the input dtype, base-2 online softmax, and the
// denominator summed from the same bf16-rounded p that multiplies V
// ("fused_l"). The optional output is the base-2 logsumexp per row, [B,H,T]
// fp32, which the training slice's backward will read.
//
// Layout: q, k, v are [B, T, H, D] read through their strides (the last one
// must be 1, the others multiples of 8, the base 16-byte aligned), so the
// q|k|v slices of a fused QKV projection need no copy.
// o is a contiguous [B, T, H, D].
//
// Design: one block of 4 warps per (b*h, 64-row q tile); each warp owns 16
// query rows. K/V tiles of 64 keys are staged in shared memory; S = Q K^T and
// O += P V run on the tensor cores through WMMA (bf16 in, fp32 accumulate,
// 16x16x16). The softmax runs on the fp32 S tile in shared memory, one row
// at a time per warp, two columns per lane. The running max, denominator and
// output accumulator are fp32. Ragged q rows and key columns past T are
// masked. D must be a multiple of 16 and at most 64.
//
// What bounds it: at the serving shapes (T = 256/1024/4096, D = 16/32) the
// FLOPs (4*B*H*T^2*D) need far less time at the bf16 tensor-core rate than
// the B*H*T^2 exponentials need on the SFUs, and this first version spends
// most of its time in the scalar softmax and the shared-memory round trips
// of S and P. Keeping S and P in registers (mma.sync fragments or wgmma) is
// the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile (two columns per lane)
constexpr int NWARPS = BQ / 16; // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Layout {
  size_t q, k, v, s, p, o, m, l, alpha, total;
  __host__ __device__ explicit Layout(int D) {
    size_t off = 0;
    q = off; off += align128(sizeof(bf16) * BQ * D);
    k = off; off += align128(sizeof(bf16) * BK * D);
    v = off; off += align128(sizeof(bf16) * BK * D);
    s = off; off += align128(sizeof(float) * BQ * BK);
    p = off; off += align128(sizeof(bf16) * BQ * BK);
    o = off; off += align128(sizeof(float) * BQ * D);
    m = off; off += align128(sizeof(float) * BQ);
    l = off; off += align128(sizeof(float) * BQ);
    alpha = off; off += align128(sizeof(float) * BQ);
    total = off;
  }
};

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy a [rows, D] tile starting at sequence position t0 into shared memory
// in 16-byte loads, zero-filling rows at or past T. The wrapper checks that
// the base pointer is 16-byte aligned and the strides are multiples of 8.
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

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int H, int D, long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                 long long vsh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(D);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);
  float* sA = reinterpret_cast<float*>(smem + L.alpha);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  // Q tile, pre-scaled in bf16 as the TPU kernel's caller does.
  load_tile(sQ, qb, qst, q0, BQ, T, D);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS)
    sQ[i] = __float2bfloat16(__bfloat162float(sQ[i]) * scale);

  const int row0 = warp * 16;
  for (int kv0 = 0; kv0 < T; kv0 += BK) {
    __syncthreads();  // previous tile fully consumed; scaled Q visible
    load_tile(sK, kb, kst, kv0, BK, T, D);
    load_tile(sV, vb, vst, kv0, BK, T, D);
    __syncthreads();

    // S[row0:row0+16, :] = Q K^T (fp32).
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + row0 * D + kk * 16, D);
        wmma::load_matrix_sync(fb, sK + n * 16 * D + kk * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + row0 * BK + n * 16, acc, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, base 2, one row at a time.
    const int nvalid = min(BK, T - kv0);
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const float* srow = sS + row * BK;
      const bool ok0 = lane < nvalid, ok1 = lane + 32 < nvalid;
      const float s0 = ok0 ? srow[lane] : NEG_INF;
      const float s1 = ok1 ? srow[lane + 32] : NEG_INF;
      const float m_prev = sM[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const bf16 p0 = __float2bfloat16(ok0 ? exp2f(s0 - m_new) : 0.f);
      const bf16 p1 = __float2bfloat16(ok1 ? exp2f(s1 - m_new) : 0.f);
      sP[row * BK + lane] = p0;
      sP[row * BK + lane + 32] = p1;
      const float psum = warp_sum(__bfloat162float(p0) + __bfloat162float(p1));
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        sA[row] = alpha;
        sL[row] = sL[row] * alpha + psum;
        sM[row] = m_new;
      }
    }
    __syncwarp();

    // PV for this warp's rows into its (now free) rows of S, then rescale-add.
    for (int dn = 0; dn < D / 16; ++dn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + row0 * BK + kk * 16, BK);
        wmma::load_matrix_sync(fb, sV + kk * 16 * D + dn * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + row0 * BK + dn * 16, acc, BK, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int row = row0 + i / D, c = i % D;
      sO[row * D + c] = sO[row * D + c] * sA[row] + sS[row * BK + c];
    }
  }
  __syncwarp();

  const int H_D = H * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int row = row0 + i / D, c = i % D;
    const int t = q0 + row;
    if (t < T) o[((long long)b * T + t) * H_D + h * D + c] = __float2bfloat16(sO[row * D + c] / sL[row]);
  }
  if (lse != nullptr && lane < 16) {
    const int row = row0 + lane;
    const int t = q0 + row;
    if (t < T) lse[((long long)b * H + h) * T + t] = sM[row] + log2f(sL[row]);
  }
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: q (b, t, h), k (b, t, h), v (b, t, h) in elements.
// lse may be null. Returns the cudaError_t of the launch.
int moegan_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int T, int H, int D, const long long* strides,
                               float scale, void* stream) {
  const Layout L(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, NTHREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), T, H, D, strides[0], strides[1],
      strides[2], strides[3], strides[4], strides[5], strides[6], strides[7], strides[8],
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
