// The generator's x2 bilinear upsample for Hopper (sm_90a), NHWC: forward
// and backward.
//
// Replaces no TPU kernel. The JAX package upsamples with jax.image.resize
// (moegan_tpu/core/upsample.py), which XLA fuses; the port called
// F.interpolate on a permuted fp32 copy, whose NCHW kernel gives one thread
// an output pixel and loops it over batch x channels (64 to 4,096 threads on
// a few SMs), and held about half of every training step and generation call
// on the H100 (PERF.md, bottleneck C1). This kernel is parallel over batch x
// pixels x channels instead.
//
// x [B, H, W, C] -> y [B, 2H, 2W, C], bf16 or fp32, half-pixel centres
// (align_corners=False), with PyTorch's taps and weights at scale 2: output
// row 2i mixes input rows (i-1, i) with weights (0.25, 0.75), or at i = 0
// rows (0, 1) with (1, 0); output row 2i+1 mixes (i, min(i+1, H-1)) with
// (0.75, 0.25). Columns alike. A value is
//
//   y = wr0 * (wc0 * x[r0][c0] + wc1 * x[r0][c1]) + wr1 * (wc0 * x[r1][c0] + wc1 * x[r1][c1])
//
// in fp32, in that order (row weights outer, as PyTorch's kernel), rounded
// once to x's type.
//
// Forward: a thread owns one input position (b, i, j) and one vector of VEC
// channels (16 bytes: 8 bf16 or 4 fp32). It loads the 3x3 edge-clamped
// neighbourhood (neighbouring threads share it through L1 and L2), forms its
// four outputs (2i + di, 2j + dj) and writes them as 16-byte vectors,
// neighbouring threads on neighbouring channels.
//
// Backward: grad_x[i][j] is the separable gather of grad_y over output rows
// 2i-1 .. 2i+2 and columns 2j-1 .. 2j+2, weights (0.25, 0.75, 0.75, 0.25),
// where the edge clamp folds weight back: row 2i weighs 1 at i = 0 (and row
// 2i-1 is absent), row 2i+1 weighs 1 at i = H-1 (and row 2i+2 is absent).
// Each row's columns are summed in order, then the rows in order, in fp32,
// rounded once. No atomics and no zero-fill: two calls give the same bits.
//
// What bounds both: bytes. The forward reads B*H*W*C elements and writes
// four times as many; the backward reads the four and writes the one. Each
// thread keeps 9 (forward) or up to 16 (backward) 16-byte loads in flight,
// issued before any arithmetic, and the grid has B*H*W*C/VEC threads: at
// the generator's smallest rung (r8, C_in 512, batch 256) already 262,144.
// A C that is not a multiple of VEC, or an x or y not 16-byte aligned, takes
// the same template at VEC = 1; the entry points choose from C and the
// pointers. The grid's y axis is the batch (chunks of 65,535 images).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ inline T from_float(float v);
template <> __device__ inline float from_float<float>(float v) { return v; }
template <> __device__ inline bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// A vector of VEC elements of T as one register load or store.
template <typename T, int VEC> struct Pack;

template <> struct Pack<bf16, 8> {
  using raw = uint4;
  __device__ static raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(const raw& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static raw pack(const float (&f)[8]) {
    raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
};

template <> struct Pack<float, 4> {
  using raw = float4;
  __device__ static raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void unpack(const raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static raw pack(const float (&f)[4]) { return make_float4(f[0], f[1], f[2], f[3]); }
};

template <typename T> struct Pack<T, 1> {
  using raw = T;
  __device__ static raw zero() { return from_float<T>(0.f); }
  __device__ static void unpack(const raw& r, float (&f)[1]) { f[0] = to_float(r); }
  __device__ static raw pack(const float (&f)[1]) { return from_float<T>(f[0]); }
};

template <typename T, int VEC>
__device__ inline typename Pack<T, VEC>::raw load(const T* __restrict__ p) {
  return *reinterpret_cast<const typename Pack<T, VEC>::raw*>(p);
}

// The thread's position: input pixel (i, j) of image blockIdx.y and the
// vector v of its channels; false past the image's H * W * NV vectors.
struct Position {
  int i, j, c;
};

__device__ inline bool position(int H, int W, int NV, int VEC, Position& at) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= H * W * NV) return false;
  const int p = t / NV;
  at.c = (t - p * NV) * VEC;
  at.i = p / W;
  at.j = p - at.i * W;
  return true;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    upsample2x_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int C) {
  using P = Pack<T, VEC>;
  Position at;
  if (!position(H, W, C / VEC, VEC, at)) return;
  const long long b = blockIdx.y;
  const int rows[3] = {max(at.i - 1, 0), at.i, min(at.i + 1, H - 1)};
  const int cols[3] = {max(at.j - 1, 0), at.j, min(at.j + 1, W - 1)};
  typename P::raw raw[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T* row = x + ((b * H + rows[r]) * W) * C + at.c;
#pragma unroll
    for (int q = 0; q < 3; ++q) raw[r][q] = load<T, VEC>(row + static_cast<long long>(cols[q]) * C);
  }
  // Even outputs (2i, 2j): taps (i-1, i) at (0.25, 0.75), or (0, 1) at (1, 0)
  // on the first row or column; odd outputs: (i, i+1 clamped) at (0.75, 0.25).
  const bool top = at.i > 0, left = at.j > 0;
  const float er0 = top ? 0.25f : 1.f, er1 = top ? 0.75f : 0.f;
  const float ec0 = left ? 0.25f : 1.f, ec1 = left ? 0.75f : 0.f;
  // Each loaded row mixed along columns: into output column 2j (even) and 2j+1 (odd).
  float even[3][VEC], odd[3][VEC];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float f[3][VEC];
#pragma unroll
    for (int q = 0; q < 3; ++q) P::unpack(raw[r][q], f[q]);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float a = left ? f[0][k] : f[1][k], bb = left ? f[1][k] : f[2][k];
      even[r][k] = ec0 * a + ec1 * bb;
      odd[r][k] = 0.75f * f[1][k] + 0.25f * f[2][k];
    }
  }
  float out[2][2][VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float e0 = top ? even[0][k] : even[1][k], e1 = top ? even[1][k] : even[2][k];
    const float o0 = top ? odd[0][k] : odd[1][k], o1 = top ? odd[1][k] : odd[2][k];
    out[0][0][k] = er0 * e0 + er1 * e1;
    out[0][1][k] = er0 * o0 + er1 * o1;
    out[1][0][k] = 0.75f * even[1][k] + 0.25f * even[2][k];
    out[1][1][k] = 0.75f * odd[1][k] + 0.25f * odd[2][k];
  }
  const int W2 = 2 * W;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    T* row = y + ((b * 2 * H + 2 * at.i + di) * W2 + 2 * at.j) * C + at.c;
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
      *reinterpret_cast<typename P::raw*>(row + dj * C) = P::pack(out[di][dj]);
  }
}

// Weights of output rows (or columns) 2i-1, 2i, 2i+1, 2i+2 in grad_x[i] of
// an axis of n inputs; 0 where the output row is absent.
__device__ inline void gather_weights(int i, int n, float (&w)[4]) {
  w[0] = i > 0 ? 0.25f : 0.f;
  w[1] = i > 0 ? 0.75f : 1.f;
  w[2] = i < n - 1 ? 0.75f : 1.f;
  w[3] = i < n - 1 ? 0.25f : 0.f;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    upsample2x_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int H, int W, int C) {
  using P = Pack<T, VEC>;
  Position at;
  if (!position(H, W, C / VEC, VEC, at)) return;
  const long long b = blockIdx.y;
  const int W2 = 2 * W;
  float wr[4], wc[4];
  gather_weights(at.i, H, wr);
  gather_weights(at.j, W, wc);
  // Absent rows and columns load nothing and add an exact 0.
  typename P::raw raw[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int orow = 2 * at.i - 1 + r;
    const T* row = dy + ((b * 2 * H + orow) * W2) * C + at.c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ocol = 2 * at.j - 1 + q;
      raw[r][q] = (wr[r] != 0.f && wc[q] != 0.f)
                      ? load<T, VEC>(row + static_cast<long long>(ocol) * C)
                      : P::zero();
    }
  }
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float s[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float f[VEC];
      P::unpack(raw[r][q], f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[k] += wc[q] * f[k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += wr[r] * s[k];
  }
  *reinterpret_cast<typename P::raw*>(dx + ((b * H + at.i) * W + at.j) * C + at.c) = P::pack(acc);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One launch a chunk of at most kMaxGridY images; src and dst advance by
// their images' elements.
template <typename T, int VEC, bool BWD>
int launch(const void* src, void* dst, int B, int H, int W, int C, cudaStream_t stream) {
  const long long in_image = static_cast<long long>(H) * W * C;
  const long long src_image = BWD ? 4 * in_image : in_image;
  const long long dst_image = BWD ? in_image : 4 * in_image;
  const dim3 block(kThreads);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int n = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const dim3 grid(static_cast<unsigned>((in_image / VEC + kThreads - 1) / kThreads), n);
    const T* s = static_cast<const T*>(src) + b0 * src_image;
    T* d = static_cast<T*>(dst) + b0 * dst_image;
    if constexpr (BWD) {
      upsample2x_bwd_kernel<T, VEC><<<grid, block, 0, stream>>>(s, d, H, W, C);
    } else {
      upsample2x_fwd_kernel<T, VEC><<<grid, block, 0, stream>>>(s, d, H, W, C);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// 16-byte vectors where C is a multiple of them and both pointers are
// aligned, else single elements.
template <bool BWD>
int dispatch(const void* src, void* dst, int B, int H, int W, int C, int is_bf16, void* stream) {
  // The thread index of an image (H * W * C / VEC) is an int.
  if (B < 1 || H < 1 || W < 1 || C < 1 ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = aligned16(src) && aligned16(dst);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return aligned && C % 8 == 0 ? launch<bf16, 8, BWD>(src, dst, B, H, W, C, s)
                                 : launch<bf16, 1, BWD>(src, dst, B, H, W, C, s);
  }
  return aligned && C % 4 == 0 ? launch<float, 4, BWD>(src, dst, B, H, W, C, s)
                               : launch<float, 1, BWD>(src, dst, B, H, W, C, s);
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y [B, 2H, 2W, C] = the x2 bilinear upsample of x [B, H, W, C], both
// contiguous, bf16 (is_bf16) or fp32. Returns a cudaError_t.
int moegan_upsample2x_fwd(const void* x, void* y, int B, int H, int W, int C, int is_bf16,
                          void* stream) {
  return dispatch<false>(x, y, B, H, W, C, is_bf16, stream);
}

// dx [B, H, W, C] for the cotangent dy [B, 2H, 2W, C] of the forward, both
// contiguous and of one type (bf16 or fp32). Returns a cudaError_t.
int moegan_upsample2x_bwd(const void* dy, void* dx, int B, int H, int W, int C, int is_bf16,
                          void* stream) {
  return dispatch<true>(dy, dx, B, H, W, C, is_bf16, stream);
}

}  // extern "C"
