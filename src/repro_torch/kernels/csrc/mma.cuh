// Tensor-core and async-copy helpers of the port's Hopper kernels (sm_90a):
// 16-byte cp.async with zero fill, ldmatrix and the bf16 mma.sync m16n8k16
// with fp32 accumulation.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4):
//   A (16 x 16, row-major): a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k),
//                           a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, same);
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, col g);
//   C (16 x 8, fp32):       c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8).
// Each 32-bit register holds two bf16, the lower k (or column) in the low half.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes global -> shared without registers.  With ok false the
// destination is zero-filled and nothing is read (src must still be a
// valid address: callers pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register j receives matrix j in the A/B fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// As ldmatrix_x4, each matrix transposed: from a row-major (k, n) tile it
// gives B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b on the tensor cores: bf16 products (exact in fp32), fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values rounded to bf16 and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// Splits two fp32 values into bf16 pieces hi + lo: hi = bf16(v), lo =
// bf16(v - hi), 16 significant bits in all (relative error <= 2^-17).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Splits two fp32 values into bf16 pieces hi + mid + lo whose sum is each
// value exactly (8 + 8 + 8 significant bits cover fp32's 24; each residual
// is exact in fp32) for finite values away from the ends of the exponent
// range; near fp32's largest values bf16(x) can round to inf.
__device__ __forceinline__ void split_bf16x3(float2 v, uint32_t& hi, uint32_t& mid,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = v.x - hf.x, ry = v.y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = pack_bf16(rx - mf.x, ry - mf.y);
}
