// Register-tile helpers shared by flash_attention.cu and flash_attention_bwd.cu:
// cp.async staging, ldmatrix, and the m16n8k16 bf16 mma.sync, as inline PTX
// for sm_90a.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), for lane = 4*g + tq:
//   A, 16x16 row-major, four bf16x2 registers:
//     a0 = (row g,   cols 2tq, 2tq+1)   a1 = (row g+8, cols 2tq, 2tq+1)
//     a2 = (row g,   cols 2tq+8, +9)    a3 = (row g+8, cols 2tq+8, +9)
//   B, 16x8 (k x n), two bf16x2 registers:
//     b0 = (rows k 2tq, 2tq+1, col g)   b1 = (rows k 2tq+8, +9, col g)
//   C, 16x8 fp32, four registers:
//     c0, c1 = (row g, cols 2tq, 2tq+1)  c2, c3 = (row g+8, cols 2tq, 2tq+1)
// Two C tiles side by side (cols 0-7 and 8-15), packed to bf16x2 as
// {c0c1 of the first, c2c3 of the first, c0c1 of the second, c2c3 of the
// second}, are exactly an A fragment: so a score tile becomes the A operand
// of the next product without leaving registers.
//
// Shared-memory tiles hold rows of D bf16 padded to D + 8 (row pitch
// 2D + 16 bytes): the eight 16-byte row segments that one ldmatrix phase
// reads then fall in eight different 16-byte bank groups for every D that
// is a multiple of 16, so ldmatrix has no bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int KV_TILE = 64;  // keys (forward, dq) or query rows (dk/dv) per streamed tile
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a Hopper block may use

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

__host__ __device__ constexpr int pitch(int D) { return D + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows t0 .. t0 + rows - 1 of a [T, D] bf16 sequence (row stride `st`
// elements) into a shared tile of pitch D + 8, in 16-byte cp.async copies;
// rows at or past T are zero-filled. All NT threads of the block take part.
template <int D, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base, long long st, int t0,
                                           int rows, int T) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    const int t = t0 + r;
    const bool ok = t < T;
    cp_async16(dst + r * pitch(D) + c * 8, ok ? base + t * st + c * 8 : base, ok);
  }
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment of the 16x16 block at (row0, col0) of a row-major tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * pitch(D) + col0 + (lane >> 4) * 8);
}

// B fragments of two 8-column n-tiles for X^T, X row-major [n][k]: rows
// n0 .. n0 + 15 of the tile, k columns col0 .. col0 + 15. b[0], b[1] feed
// n-tile n0, b[2], b[3] n-tile n0 + 8.
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int n0, int col0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch(D) + col0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-column n-tiles for X, X row-major [k][n]: k rows
// k0 .. k0 + 15, n columns n0 .. n0 + 15 (ldmatrix.trans). b[0], b[1] feed
// n-tile n0, b[2], b[3] n-tile n0 + 8.
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch(D) + n0 + (lane >> 4) * 8);
}

// c += a b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU: ex2.approx.ftz.f32, one MUFU instruction. Results below
// 2^-126 flush to 0, where exp2f would keep them subnormal at the cost of a
// range fix-up of three more instructions; such p lie 2^126 below the row's
// largest p (which is 1) and change no bf16 or fp32 sum of them.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// Each bf16 of a packed pair multiplied by `scale` in fp32 and rounded back.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f = unpack_bf16(x);
  return pack_bf16(f.x * scale, f.y * scale);
}

// A warp's [16 x D] fp32 accumulator (D / 8 C tiles) times `mul`, rounded
// to bf16, into rows t0 .. t0 + 15 of a contiguous [B, T, H, D] output: the
// warp's 16 rows of the shared tile `stage` (pitch D + 8) take the bf16 rows,
// then each lane writes whole 16-byte segments. Rows at or past T are skipped.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bf16* stage,
                                           bf16* out, int b, int h, int t0, int T, int H) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  __syncwarp();  // the warp's last ldmatrix reads of these rows come first
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * pitch(D) + n * 8 + 2 * tq) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * pitch(D) + n * 8 + 2 * tq) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int PER_ROW = D / 8;
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    const int t = t0 + r;
    if (t < T)
      *reinterpret_cast<uint4*>(out + (((long long)b * T + t) * H + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * pitch(D) + c * 8);
  }
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) on the
// current device, once per device (`done` keeps one bit per device), so that
// a launch costs no attribute call after the first.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace flash
