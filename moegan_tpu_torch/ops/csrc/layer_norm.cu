// LayerNorm over the last axis for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels moegan_tpu/ops/fused_layernorm.py::_fwd_kernel
// (launched by _fwd_impl) and ::_bwd_kernel (launched by _bwd_rule), which
// the JAX package runs under MOEGAN_FUSED_LN=1 in norm1/norm2/norm3 of every
// attention block. For each row of x [N, C] (bf16 or fp32, 1 <= C <= 512):
//
//   mu = mean(x), var = mean((x - mu)^2)          (fp32, biased, two passes)
//   inv = rsqrt(var + eps), xhat = (x - mu) * inv
//   y = xhat * scale + bias                       (rounded once to x's type)
//
// and for the cotangent dy, recomputing mu and inv from x as the TPU kernel
// does (the backward reads x for xhat anyway, so saved statistics would add
// bytes and save none):
//
//   g = dy * scale
//   dx = inv * (g - mean(g) - xhat * mean(g * xhat))   (x's type)
//   dscale = sum_rows dy * xhat, dbias = sum_rows dy   (fp32)
//
// What bounds both: bytes. The forward moves 2 * N * C elements, the backward
// 3 * N * C, with O(C) FLOPs per row. The design keeps enough 16-byte loads
// in flight to run device memory at its rate, at every row width:
//
// - Lane groups sized to the row. A row is spread over a group of G lanes,
//   each holding `NV` vectors of VEC elements (16 bytes: 8 bf16 or 4 fp32)
//   in registers: lane j of the group loads columns (v * G + j) * VEC ...,
//   so neighbouring lanes read neighbouring addresses. G = min(32, C / VEC)
//   rounded up to a power of two (C = 32 in bf16: 4 lanes a row, 8 rows a
//   warp; C = 512: 32 lanes, two vectors each). The row's sums are
//   __shfl_xor_sync trees inside the group; a row is read once and written
//   once. The statistics multiply by 1 / C; a vector lies wholly below C or
//   past it, so the masks are per vector.
// - A width that is not a multiple of the vector, or an x, y, dy, dx, scale
//   or bias that is not 16-byte aligned, takes the same template at VEC = 1
//   (columns past C masked); layer_norm_plan in ops/layernorm.py chooses,
//   and the entry points check its choice.
// - scale and bias are loaded once a thread, into registers (as 16-byte
//   vectors), before the row loop. Each thread loads its next row before it
//   reduces the current one, so two rows' loads are in flight.
// - Persistent grids, no more blocks than the card holds at once. The
//   forward's launch bounds hold 4 blocks of 256 an SM (64 registers) at
//   <= 8 columns a thread, 2 above; 8 blocks an SM (2,048 threads) would
//   leave 32 registers, where this kernel spilled 80-96 bytes a thread and
//   ran slower (PERF.md, PR 12). The backward's hold 2 blocks an SM at <= 8
//   columns a thread, 1 above (2 spilled there).
//
// The TPU kernel carries dscale and dbias across its sequential grid. Here
// blocks run in parallel. Each thread sums its columns' dy * xhat and dy over
// its rows in fp32 registers; the warp adds its row groups (an xor tree), the
// block adds its warps in order through shared memory into one partial row of
// `part` [blocks, 2, C]. Then, in the same launch, each block takes a ticket
// from a device counter (after its barrier, one thread's acquire-release
// atomic add, as cooperative groups' grid barrier takes it). The last 8
// blocks to take one wait until every block has, and block k of them adds
// slice k of the 2C outputs over the partial rows in block order (16-byte
// loads where C is even); the last of them to finish sets the counter back
// to 0. One block adding every slice, or a second launch for the sum,
// measured slower (PERF.md, PR 12). Only those 8 wait, for blocks that hold a
// slot or get one as the others exit. The grid (2 blocks an SM, at most one
// a 8 rows) depends on N and the SM count alone, so every sum has a fixed
// order: two calls give the same bits, whichever blocks add the slices. The
// counter is one int per device (the wrapper allocates it once and caches
// it), so calls on one device must be serialised, as the port runs them on
// the current stream; a CUDA graph that captures the backward replays it
// correctly because the counter is back at 0 after every call.

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxC = 512;
constexpr int kWarps = 8;  // a block of either kernel: 256 threads
constexpr int kThreads = kWarps * 32;
constexpr int kReducers = 8;  // the last backward blocks, which add the partials

// Blocks an SM holds at once, by the columns a thread keeps (VEC * NV): the
// launch bounds promise them. layer_norm_plan sizes the forward's grid with
// the same numbers; the backward's grid is 2 blocks an SM at most (a second
// wave above 8 columns a thread).
__host__ __device__ constexpr int fwd_blocks_per_sm(int cols) { return cols <= 8 ? 4 : 2; }
__host__ __device__ constexpr int bwd_blocks_per_sm(int cols) { return cols <= 8 ? 2 : 1; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

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

// Lane j of a row group holds vectors v = 0..NV-1 at columns (v * G + j) * VEC.
template <int VEC, int G>
__device__ inline int column(int v, int j) {
  return (v * G + j) * VEC;
}

// Row `row` of src [N, C] into r: zero past N and past C.
template <typename T, int VEC, int G, int NV>
__device__ inline void load_row(typename Pack<T, VEC>::raw (&r)[NV], const T* __restrict__ src,
                                long long row, int N, int C, int j) {
  using P = Pack<T, VEC>;
  const T* p = src + row * C;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = column<VEC, G>(v, j);
    r[v] = (row < N && c < C) ? *reinterpret_cast<const typename P::raw*>(p + c) : P::zero();
  }
}

template <typename T, int VEC, int G, int NV>
__device__ inline void store_row(T* __restrict__ dst, const float (&f)[NV][VEC], long long row,
                                 int N, int C, int j) {
  using P = Pack<T, VEC>;
  if (row >= N) return;
  T* p = dst + row * C;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = column<VEC, G>(v, j);
    if (c < C) *reinterpret_cast<typename P::raw*>(p + c) = P::pack(f[v]);
  }
}

// The sum over a row group of G lanes (offsets < G stay inside the group).
// Every lane of the warp calls it, so the full mask holds.
template <int G>
__device__ inline float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// scale (and bias) at this lane's columns, 0 past C: 16-byte vectors where
// VEC > 1 (the plan takes VEC > 1 only where the weights are aligned).
template <int VEC, int G, int NV>
__device__ inline void load_weights(float (&w)[NV][VEC], const float* __restrict__ src, int C,
                                    int j) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = column<VEC, G>(v, j);
    if constexpr (VEC == 1) {
      w[v][0] = c < C ? src[c] : 0.f;
    } else {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 f = c < C ? *reinterpret_cast<const float4*>(src + c + 4 * q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        w[v][4 * q] = f.x;
        w[v][4 * q + 1] = f.y;
        w[v][4 * q + 2] = f.z;
        w[v][4 * q + 3] = f.w;
      }
    }
  }
}

// Row statistics: f holds the row's values (0 past C) and becomes xhat (0
// past C); returns inv. rc = 1 / C. A vector lies wholly below C or wholly
// past it (VEC > 1 only where C is whole vectors).
template <int VEC, int G, int NV>
__device__ inline float normalize(float (&f)[NV][VEC], int C, float rc, int j, float eps) {
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += f[v][e];
  const float mu = group_sum<G>(s) * rc;
  float q = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const bool in = column<VEC, G>(v, j) < C;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = in ? f[v][e] - mu : 0.f;
      f[v][e] = d;
      q += d * d;
    }
  }
  const float inv = rsqrtf(group_sum<G>(q) * rc + eps);
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[v][e] *= inv;
  return inv;
}

// Grid-stride over row groups: warp w of block b starts at row group
// (b * warps + w) * (32 / G); the loop runs while the warp's first row is
// < N, so whole warps shuffle together and groups past N compute on zeros.
template <typename T, int VEC, int G, int NV>
__global__ void __launch_bounds__(kThreads, fwd_blocks_per_sm(VEC * NV))
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, int N, int C, float eps) {
  using P = Pack<T, VEC>;
  constexpr int kRows = 32 / G;  // rows a warp takes at once
  const int lane = threadIdx.x % 32, j = lane % G;
  float sc[NV][VEC], bi[NV][VEC];
  load_weights<VEC, G, NV>(sc, scale, C, j);
  load_weights<VEC, G, NV>(bi, bias, C, j);
  const float rc = 1.f / C;
  const long long stride = (long long)gridDim.x * kWarps * kRows;
  long long first = ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * kRows;
  long long row = first + lane / G;
  typename P::raw cur[NV], nxt[NV];
  load_row<T, VEC, G, NV>(cur, x, row, N, C, j);
  for (; first < N; first += stride, row += stride) {
    load_row<T, VEC, G, NV>(nxt, x, row + stride, N, C, j);
    float f[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) P::unpack(cur[v], f[v]);
    normalize<VEC, G, NV>(f, C, rc, j, eps);
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[v][e] = f[v][e] * sc[v][e] + bi[v][e];
    store_row<T, VEC, G, NV>(y, f, row, N, C, j);
#pragma unroll
    for (int v = 0; v < NV; ++v) cur[v] = nxt[v];
  }
}

// W consecutive floats of a partial row (W = 4: one 16-byte load).
template <int W>
__device__ inline void load_part(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// Outputs o0 <= o < o1 of dscale (o < C) and dbias (o >= C) from part
// [blocks, 2, C]: in units of W columns (W = 4 where C is even, so every row
// of part is whole 16-byte vectors and o0 is a multiple of 4), each unit
// summed over the blocks in order in S = threads / units slices of
// consecutive blocks (16 loads in flight a thread), the slices then added in
// order. tmp holds 4 * kThreads floats. Every thread of the block calls it.
template <int W>
__device__ void sum_units(const float* __restrict__ part, int blocks, int C, int o0, int o1,
                          float* __restrict__ dscale, float* __restrict__ dbias, float* tmp) {
  const int outs = 2 * C, n = o1 - o0, units = (n + W - 1) / W, t = threadIdx.x;
  const int slices = units < kThreads ? kThreads / units : 1;
  const int per = (blocks + slices - 1) / slices;
  for (int i = t; i < slices * units; i += kThreads) {
    const int sl = i / units, o = (i % units) * W;
    const int b1 = min(blocks, (sl + 1) * per);
    float s[W] = {};
    int b = min(blocks, sl * per);
    for (; b + 16 <= b1; b += 16) {
      float v[16][W];
#pragma unroll
      for (int k = 0; k < 16; ++k) load_part<W>(part + (long long)(b + k) * outs + o0 + o, v[k]);
#pragma unroll
      for (int k = 0; k < 16; ++k)
#pragma unroll
        for (int e = 0; e < W; ++e) s[e] += v[k][e];
    }
    for (; b < b1; ++b) {
      float v[W];
      load_part<W>(part + (long long)b * outs + o0 + o, v);
#pragma unroll
      for (int e = 0; e < W; ++e) s[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < W; ++e) tmp[sl * units * W + o + e] = s[e];
  }
  __syncthreads();
  for (int o = t; o < n; o += kThreads) {
    float s = 0.f;
    for (int sl = 0; sl < slices; ++sl) s += tmp[sl * units * W + o];
    if (o0 + o < C) {
      dscale[o0 + o] = s;
    } else {
      dbias[o0 + o - C] = s;
    }
  }
}

// Slice k of the 2C outputs (whole 16-byte vectors where C is even), for the
// k-th of `reducers` blocks.
__device__ inline void sum_partials(const float* __restrict__ part, int blocks, int C, int k,
                                    int reducers, float* __restrict__ dscale,
                                    float* __restrict__ dbias, float* tmp) {
  const int outs = 2 * C, W = C % 2 == 0 ? 4 : 1;
  const int per = ((outs + reducers - 1) / reducers + W - 1) / W * W;
  const int o0 = min(outs, k * per), o1 = min(outs, o0 + per);
  if (o0 == o1) return;
  if (W == 4) {
    sum_units<4>(part, blocks, C, o0, o1, dscale, dbias, tmp);
  } else {
    sum_units<1>(part, blocks, C, o0, o1, dscale, dbias, tmp);
  }
}

template <typename T, int VEC, int G, int NV>
__global__ void __launch_bounds__(kThreads, bwd_blocks_per_sm(VEC * NV))
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ part, float* __restrict__ dscale,
              float* __restrict__ dbias, unsigned* __restrict__ ticket, int N, int C,
              float eps) {
  using P = Pack<T, VEC>;
  constexpr int kRows = 32 / G;
  constexpr int kCols = G * NV * VEC;  // columns a row group covers (>= C)
  __shared__ float red[cmax(kWarps * kCols, 4 * kThreads)];
  __shared__ int role;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, j = lane % G;
  float sc[NV][VEC], ds[NV][VEC], db[NV][VEC];
  load_weights<VEC, G, NV>(sc, scale, C, j);
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[v][e] = db[v][e] = 0.f;
  const float rc = 1.f / C;
  const long long stride = (long long)gridDim.x * kWarps * kRows;
  long long first = ((long long)blockIdx.x * kWarps + warp) * kRows;
  long long row = first + lane / G;
  typename P::raw cx[NV], cg[NV], nx[NV], ng[NV];
  load_row<T, VEC, G, NV>(cx, x, row, N, C, j);
  load_row<T, VEC, G, NV>(cg, dy, row, N, C, j);
  for (; first < N; first += stride, row += stride) {
    load_row<T, VEC, G, NV>(nx, x, row + stride, N, C, j);
    load_row<T, VEC, G, NV>(ng, dy, row + stride, N, C, j);
    float f[NV][VEC], g[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      P::unpack(cx[v], f[v]);
      P::unpack(cg[v], g[v]);
    }
    const float inv = normalize<VEC, G, NV>(f, C, rc, j, eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ds[v][e] += g[v][e] * f[v][e];  // 0 past C and past N: g is 0 there
        db[v][e] += g[v][e];
        g[v][e] *= sc[v][e];
        s1 += g[v][e];
        s2 += g[v][e] * f[v][e];
      }
    }
    const float m1 = group_sum<G>(s1) * rc, m2 = group_sum<G>(s2) * rc;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[v][e] = inv * (g[v][e] - m1 - f[v][e] * m2);
    store_row<T, VEC, G, NV>(dx, g, row, N, C, j);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      cx[v] = nx[v];
      cg[v] = ng[v];
    }
  }
  // The warp's row groups hold the same columns: a fixed xor tree over them.
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ds[v][e] += __shfl_xor_sync(0xffffffffu, ds[v][e], o);
        db[v][e] += __shfl_xor_sync(0xffffffffu, db[v][e], o);
      }
    }
  }
  // The block's warps, in a fixed order: each warp's sums of dy * xhat, then
  // of dy, through shared memory, added warp by warp into the block's row of
  // part.
  float* p = part + (long long)blockIdx.x * 2 * C;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (lane < G) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          red[warp * kCols + column<VEC, G>(v, j) + e] = k ? db[v][e] : ds[v][e];
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kCols + c];
      p[k * C + c] = s;
    }
    __syncthreads();
  }
  // The ticket: after the block's barrier, one thread's acquire-release
  // atomic (as cooperative groups' grid barrier takes it, with a fence). The
  // last kReducers blocks to take one wait until every block has taken its
  // ticket, then block k of them adds slice k of the outputs; the last of
  // them to finish sets the counter back to 0. Only they wait, and every
  // other block exits after its ticket, so the blocks they wait for run.
  const unsigned blocks = gridDim.x, reducers = min(blocks, (unsigned)kReducers);
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*ticket);
    const unsigned t = count.fetch_add(1u, cuda::memory_order_acq_rel);
    role = t >= blocks - reducers ? static_cast<int>(t - (blocks - reducers)) : -1;
    if (role >= 0) {
      while (count.load(cuda::memory_order_acquire) < blocks) __nanosleep(64);
    }
  }
  __syncthreads();
  if (role < 0) return;
  sum_partials(part, blocks, C, role, reducers, dscale, dbias, red);
  if (threadIdx.x == 0 && atomicAdd(ticket, 1u) == blocks + reducers - 1) *ticket = 0u;
}

struct Args {
  const void* x;
  const float* scale;
  const float* bias;
  const void* dy;
  void* out;
  float* part;
  float* dscale;
  float* dbias;
  unsigned* ticket;
  int N, C, blocks;
  float eps;
  cudaStream_t st;
};

template <bool BWD, typename T, int VEC, int G, int NV>
int launch(const Args& a) {
  if constexpr (!BWD) {
    ln_fwd_kernel<T, VEC, G, NV><<<a.blocks, kThreads, 0, a.st>>>(
        static_cast<const T*>(a.x), a.scale, a.bias, static_cast<T*>(a.out), a.N, a.C, a.eps);
    return static_cast<int>(cudaGetLastError());
  } else {
    ln_bwd_kernel<T, VEC, G, NV><<<a.blocks, kThreads, 0, a.st>>>(
        static_cast<const T*>(a.x), a.scale, static_cast<const T*>(a.dy), static_cast<T*>(a.out),
        a.part, a.dscale, a.dbias, a.ticket, a.N, a.C, a.eps);
    return static_cast<int>(cudaGetLastError());
  }
}

// The template for (G, NV): G < 32 only with NV = 1; at G = 32, NV up to the
// vectors a lane holds at C = 512.
template <bool BWD, typename T, int VEC>
int by_layout(int group, int vectors, const Args& a) {
  constexpr int kMaxNV = kMaxC / (32 * VEC);
  switch (group) {
    case 1: return launch<BWD, T, VEC, 1, 1>(a);
    case 2: return launch<BWD, T, VEC, 2, 1>(a);
    case 4: return launch<BWD, T, VEC, 4, 1>(a);
    case 8: return launch<BWD, T, VEC, 8, 1>(a);
    case 16: return launch<BWD, T, VEC, 16, 1>(a);
    default: break;
  }
  switch (vectors) {
    case 1: return launch<BWD, T, VEC, 32, 1>(a);
    case 2: return launch<BWD, T, VEC, 32, 2>(a);
    case 4:
      if constexpr (kMaxNV >= 4) return launch<BWD, T, VEC, 32, 4>(a);
      break;
    case 8:
      if constexpr (kMaxNV >= 8) return launch<BWD, T, VEC, 32, 8>(a);
      break;
    case 16:
      if constexpr (kMaxNV >= 16) return launch<BWD, T, VEC, 32, 16>(a);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool BWD>
int by_type(int is_bf16, int vec, int group, int vectors, const Args& a) {
  if (is_bf16) {
    return vec == 8 ? by_layout<BWD, bf16, 8>(group, vectors, a)
                    : by_layout<BWD, bf16, 1>(group, vectors, a);
  }
  return vec == 4 ? by_layout<BWD, float, 4>(group, vectors, a)
                  : by_layout<BWD, float, 1>(group, vectors, a);
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 0 if the launch plan is the one layer_norm_plan gives for this call (the
// vector width, lane group, vectors a lane and rows a block at once follow
// from C, the type and the pointers' alignment; 1 <= blocks <= ceil(N /
// warps)), else cudaErrorInvalidValue.
int check_plan(int N, int C, int is_bf16, bool aligned, int vec, int group, int vectors,
               int rows, int blocks) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || C < 1 || C > kMaxC) return bad;
  const int full = is_bf16 ? 8 : 4;
  const int want_vec = (aligned && C % full == 0) ? full : 1;
  const int nvec = (C + want_vec - 1) / want_vec;
  const int want_group = pow2_at_least(nvec) < 32 ? pow2_at_least(nvec) : 32;
  const int want_vectors = pow2_at_least((nvec + want_group - 1) / want_group);
  if (vec != want_vec || group != want_group || vectors != want_vectors) return bad;
  if (rows != kWarps * (32 / group)) return bad;
  if (blocks < 1 || blocks > (N + kWarps - 1) / kWarps) return bad;
  return 0;
}

}  // namespace

extern "C" {

const char* moegan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y [N, C] = LayerNorm(x [N, C]) * scale + bias; x and y bf16 (is_bf16) or
// fp32, scale and bias fp32 [C]. 1 <= C <= 512. vec, group, vectors, rows and
// blocks: layer_norm_plan's (vec, group, vectors, rows, fwd_blocks).
// Returns a cudaError_t.
int moegan_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y, int N,
                          int C, int is_bf16, float eps, int vec, int group, int vectors,
                          int rows, int blocks, void* stream) {
  const int rc = check_plan(N, C, is_bf16,
                            aligned16(x) && aligned16(y) && aligned16(scale) && aligned16(bias),
                            vec, group, vectors, rows, blocks);
  if (rc != 0) return rc;
  const Args a{x,       static_cast<const float*>(scale), static_cast<const float*>(bias),
               nullptr, y,       nullptr,
               nullptr, nullptr, nullptr,
               N,       C,       blocks,
               eps,     static_cast<cudaStream_t>(stream)};
  return by_type<false>(is_bf16, vec, group, vectors, a);
}

// dx [N, C] (x's type), dscale and dbias fp32 [C] for the cotangent dy [N, C]
// (x's type). part: fp32 [blocks, 2, C] scratch; ticket: an unsigned int that
// is 0 (and is 0 again when the launch ends). The plan: layer_norm_plan's
// (vec, group, vectors, rows, bwd_blocks).
int moegan_layer_norm_bwd(const void* x, const void* scale, const void* dy, void* dx, void* part,
                          void* dscale, void* dbias, void* ticket, int N, int C, int is_bf16,
                          float eps, int vec, int group, int vectors, int rows, int blocks,
                          void* stream) {
  const int rc = check_plan(N, C, is_bf16,
                            aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(scale),
                            vec, group, vectors, rows, blocks);
  if (rc != 0) return rc;
  if (ticket == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,
               static_cast<const float*>(scale),
               nullptr,
               dy,
               dx,
               static_cast<float*>(part),
               static_cast<float*>(dscale),
               static_cast<float*>(dbias),
               static_cast<unsigned*>(ticket),
               N,
               C,
               blocks,
               eps,
               static_cast<cudaStream_t>(stream)};
  return by_type<true>(is_bf16, vec, group, vectors, a);
}

}  // extern "C"
