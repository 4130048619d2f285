// LayerNorm over the last axis for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels moegan_tpu/ops/fused_layernorm.py::_fwd_kernel
// (launched by _fwd_impl) and ::_bwd_kernel (launched by _bwd_rule), which
// the JAX package runs under MOEGAN_FUSED_LN=1 in norm1/norm2/norm3 of every
// attention block. For each row of x [N, C] (bf16 or fp32):
//
//   mu = mean(x), var = mean((x - mu)^2)          (fp32, biased)
//   inv = rsqrt(var + eps), xhat = (x - mu) * inv
//   y = xhat * scale + bias                       (rounded once to x's type)
//
// and for the cotangent dy, recomputing mu and inv from x as the TPU kernel
// does (nothing is saved between the passes):
//
//   g = dy * scale
//   dx = inv * (g - mean(g) - xhat * mean(g * xhat))   (x's type)
//   dscale = sum_rows dy * xhat, dbias = sum_rows dy   (fp32)
//
// One warp owns a row: lane l holds columns l, l + 32, ... in registers
// (NPL = ceil(C / 32) rounded up to a power of two, C <= 512), so a row is
// read once and written once and its sums are warp shuffles. Columns past C
// are masked; any N is taken.
//
// The TPU kernel carries dscale and dbias across its sequential grid. Here
// blocks run in parallel, so the backward has a fixed number of blocks
// (ln_bwd_blocks(N), a function of N alone), each walking a fixed range of
// rows: every warp sums its rows' dy * xhat and dy per column in registers,
// the block adds its 8 warps in order into one fp32 partial row, and a
// second launch adds the blocks' partials, one warp per output column, in a
// fixed order. No atomics: two calls give the same bits.
//
// What bounds it: bytes. The forward moves 2 * N * C elements, the backward
// 3 * N * C, with O(C) FLOPs per row; at C = 32 a warp's row is 64 bytes, so
// short rows leave the loads narrow. Wider rows per warp and vector loads
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 512;
constexpr int kMaxBwdBlocks = 1024;

__device__ inline float load(const float* p) { return *p; }
__device__ inline float load(const bf16* p) { return __bfloat162float(*p); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row statistics: v[] holds the row's values (0 past C) and becomes
// xhat (0 past C); returns inv.
template <int NPL>
__device__ inline float normalize(float (&v)[NPL], int lane, int C, float eps) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) s += v[i];
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const float d = (lane + 32 * i < C) ? v[i] - mu : 0.f;
    v[i] = d;
    q += d * d;
  }
  const float inv = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < NPL; ++i) v[i] *= inv;
  return inv;
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, int N, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= N) return;
  const T* xr = x + row * C;
  float v[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? load(xr + c) : 0.f;
  }
  normalize(v, lane, C, eps);
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) store(yr + c, v[i] * scale[c] + bias[c]);
  }
}

// Block b owns rows [b * rpb, min(N, (b + 1) * rpb)); warp w of it takes
// every 8th of them. part [blocks, 2, C]: the block's sums of dy * xhat
// (row 0) and dy (row 1). Dynamic shared memory: [8 warps][2][C] fp32.
template <typename T, int NPL>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part, int N,
              int C, int rpb, float eps) {
  extern __shared__ float red[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = min((long long)N, r0 + rpb);
  float sc[NPL], ds[NPL], db[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    sc[i] = c < C ? scale[c] : 0.f;
    ds[i] = 0.f;
    db[i] = 0.f;
  }
  for (long long row = r0 + warp; row < r1; row += kWarps) {
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    float v[NPL], g[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? load(xr + c) : 0.f;
      g[i] = c < C ? load(dyr + c) : 0.f;
    }
    const float inv = normalize(v, lane, C, eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      ds[i] += g[i] * v[i];
      db[i] += g[i];
      g[i] *= sc[i];
      s1 += g[i];
      s2 += g[i] * v[i];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    T* dxr = dx + row * C;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) store(dxr + c, inv * (g[i] - m1 - v[i] * m2));
    }
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      red[(warp * 2 + 0) * C + c] = ds[i];
      red[(warp * 2 + 1) * C + c] = db[i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * 2 * C + i];
    part[(long long)blockIdx.x * 2 * C + i] = s;
  }
}

// out[i] for i < 2C (dscale then dbias) = the sum over blocks of part[:, i]:
// one warp per output, lane l adding blocks l, l + 32, ... in order, then a
// fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
ln_bwd_finish_kernel(const float* __restrict__ part, float* __restrict__ dscale,
                     float* __restrict__ dbias, int blocks, int C) {
  const int out = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (out >= 2 * C) return;
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += part[(long long)b * 2 * C + out];
  s = warp_sum(s);
  if (lane == 0) {
    if (out < C) {
      dscale[out] = s;
    } else {
      dbias[out - C] = s;
    }
  }
}

int npl_for(int C) {
  int n = 1;
  while (32 * n < C) n *= 2;
  return n;
}

int bwd_blocks(int N) {
  const int b = (N + kWarps - 1) / kWarps;
  return b < kMaxBwdBlocks ? (b > 0 ? b : 1) : kMaxBwdBlocks;
}

template <typename T, int NPL>
int launch(const void* x, const void* scale, const void* bias, const void* dy, void* out,
           void* part, void* dscale, void* dbias, int N, int C, float eps, bool backward,
           cudaStream_t st) {
  if (!backward) {
    ln_fwd_kernel<T, NPL><<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(out), N, C, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = bwd_blocks(N);
  const int rpb = (N + blocks - 1) / blocks;
  ln_bwd_kernel<T, NPL><<<blocks, kThreads, sizeof(float) * kWarps * 2 * C, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(out), static_cast<float*>(part), N, C, rpb, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_finish_kernel<<<(2 * C + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale), static_cast<float*>(dbias),
      blocks, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, const void* dy, void* out,
             void* part, void* dscale, void* dbias, int N, int C, float eps, bool backward,
             cudaStream_t st) {
  switch (npl_for(C)) {
    case 1: return launch<T, 1>(x, scale, bias, dy, out, part, dscale, dbias, N, C, eps, backward, st);
    case 2: return launch<T, 2>(x, scale, bias, dy, out, part, dscale, dbias, N, C, eps, backward, st);
    case 4: return launch<T, 4>(x, scale, bias, dy, out, part, dscale, dbias, N, C, eps, backward, st);
    case 8: return launch<T, 8>(x, scale, bias, dy, out, part, dscale, dbias, N, C, eps, backward, st);
    default: return launch<T, 16>(x, scale, bias, dy, out, part, dscale, dbias, N, C, eps, backward, st);
  }
}

int run(const void* x, const void* scale, const void* bias, const void* dy, void* out,
        void* part, void* dscale, void* dbias, int N, int C, int is_bf16, float eps,
        bool backward, void* stream) {
  if (N < 1 || C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(x, scale, bias, dy, out, part, dscale, dbias, N, C, eps, backward, st)
                 : dispatch<float>(x, scale, bias, dy, out, part, dscale, dbias, N, C, eps, backward, st);
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of blocks of the backward at N rows: the row count of its
// partial-sum buffer.
int moegan_layer_norm_bwd_blocks(int N) { return bwd_blocks(N); }

// y [N, C] = LayerNorm(x [N, C]) * scale + bias; x and y bf16 (is_bf16) or
// fp32, scale and bias fp32 [C]. 1 <= C <= 512. Returns a cudaError_t.
int moegan_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y, int N,
                          int C, int is_bf16, float eps, void* stream) {
  return run(x, scale, bias, nullptr, y, nullptr, nullptr, nullptr, N, C, is_bf16, eps, false,
             stream);
}

// dx [N, C] (x's type), dscale and dbias fp32 [C] for the cotangent dy [N, C]
// (x's type). part: fp32 [moegan_layer_norm_bwd_blocks(N), 2, C] scratch.
int moegan_layer_norm_bwd(const void* x, const void* scale, const void* dy, void* dx, void* part,
                          void* dscale, void* dbias, int N, int C, int is_bf16, float eps,
                          void* stream) {
  return run(x, scale, nullptr, dy, dx, part, dscale, dbias, N, C, is_bf16, eps, true, stream);
}

}  // extern "C"
