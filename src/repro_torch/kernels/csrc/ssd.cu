// Mamba2 SSD intra-chunk term for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py:51
// ssd_intra_chunk (body _ssd_kernel :27): for every (g = batch*chunk, head)
//
//     cs = cumsum(dA)                                   (fp32, over the chunk)
//     Y[l] = sum_{s <= l} exp(cs[l] - cs[s]) * (C[l].B[s]) * x[s]
//
// with every operation in fp32 and one rounding to x's dtype at the end.
//
// What bounds it on an H100: at mamba2-370m's serving prefill (g = 32
// chunks of 256, 32 heads, p = 64, n = 128) the causal work is ~12.9 GFLOP
// against ~72 MB of bf16 traffic (B and C read once per chunk through their
// stride-0 head views, 0.02 ms).  Two thirds of it, C.B^T, takes bf16
// operands whose products are exact in fp32, so bf16 tensor cores with fp32
// accumulation compute it unchanged (8.6 GFLOP at 989 TFLOP/s); the rest,
// (decayed fp32 scores).x, runs at the fp32 rate (4.3 GFLOP at 67 TFLOP/s):
// ~0.073 ms in all.  It is operation-bound; this version does all of it on
// the CUDA cores.
//
// Design (first, simple version).  The TPU kernel holds the whole (cl, cl)
// fp32 score tile of one (g, h) in VMEM; at cl = 256 that is 256 KB, more
// than a block's 227 KB of shared memory.  So it is tiled as flash
// attention is, without the softmax: one 256-thread block per (64-row query
// tile, head, g).  The block
//   1. computes cs for the whole chunk into shared memory (warp 0: a warp
//      scan accumulated in fp64 and rounded once per prefix to fp32; for a
//      chunk's <= 256 terms the fp64 sums are exact in practice, so cs does
//      not depend on the order of the sum and equals the plain version's.
//      The TPU kernel sums in fp32, but an fp32 scan's value depends on its
//      order by about the 3e-5 this kernel is held to; see ssd/ref.py);
//   2. stages its C rows (64 x n, fp32) once;
//   3. walks the key tiles at or below its diagonal (tiles above it give
//      exact zeros for finite inputs and are skipped): stage B_t (64 x n)
//      and x_t (64 x p), scores = C_q . B_t^T in fp32 (4 x 4 per thread),
//      times exp(cs_l - cs_s) where s <= l, 0 elsewhere, into shared
//      memory, then y += scores . x_t (4 x p/16 per thread, in registers).
// The decay is the exponential of the DIFFERENCE cs_l - cs_s, never
// exp(cs_l) * exp(-cs_s), which overflows to inf (and gives NaN) under a
// strong decay where the reference gives 0.  Rows and keys past the chunk
// length (cl need not be a multiple of 64) are zero on load, masked in the
// decay and never stored.  x, B and C are read through their strides, so
// head-broadcast B/C views (stride 0 on the head axis) need no copy.
// Shared memory is ~100 KB at n = 128, p = 64 (dynamic, above the 48 KB
// default through cudaFuncSetAttribute): two blocks per SM.  No tensor
// cores yet.

#include "common.cuh"

namespace {

constexpr int BT = 64;        // query rows per block = keys per tile
constexpr int THREADS = 256;  // 16 x 16; thread (ty, tx) owns rows ty + 16 i
constexpr int MAX_CL = 256;

struct Str3 {
  long long g, l, h;
};

inline size_t smem_bytes(int n, int pj) {
  return sizeof(float) *
         (MAX_CL + 2 * BT * (n + 1) + BT * 16 * pj + BT * (BT + 1));
}

// PJ: output columns per thread, p <= 16 * PJ.
template <int PJ, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_intra_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dA,
                       const T* __restrict__ B, const T* __restrict__ C,
                       T* __restrict__ out, int CL, int H, int P, int N,
                       Str3 xs, Str3 bs, Str3 cs_, Str3 das) {
  constexpr int XC = 16 * PJ;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                  // [MAX_CL]
  float* cq = cs + MAX_CL;           // [BT][N + 1]
  float* bk = cq + BT * (N + 1);     // [BT][N + 1]
  float* xk = bk + BT * (N + 1);     // [BT][XC]
  float* ss = xk + BT * XC;          // [BT][BT + 1]
  const int ldn = N + 1;

  const int n_qt = (CL + BT - 1) / BT;
  const int qt = n_qt - 1 - blockIdx.x;  // the longest walks start first
  const int h = blockIdx.y, g = blockIdx.z;
  const int q0 = qt * BT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // 1. cs over the whole chunk: each lane sums its slice in fp64, a warp
  //    scan adds the lanes before it, every prefix is rounded once.
  if (tid < 32) {
    constexpr int PER = MAX_CL / 32;
    const T* dap = dA + g * das.g + h * das.h;
    double v[PER];
    double run = 0.0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int l = tid * PER + i;
      run += l < CL ? (double)to_f32(dap[(long long)l * das.l]) : 0.0;
      v[i] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const double up = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += up;
    }
    const double before = incl - run;
#pragma unroll
    for (int i = 0; i < PER; ++i) cs[tid * PER + i] = (float)(before + v[i]);
  }

  // 2. The block's C rows, fp32, zero past the chunk.
  const T* cp = C + g * cs_.g + h * cs_.h;
  for (int i = tid; i < BT * N; i += THREADS) {
    const int r = i / N, c = i % N, l = q0 + r;
    cq[r * ldn + c] = l < CL ? to_f32(cp[(long long)l * cs_.l + c]) : 0.f;
  }

  float y[4][PJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) y[i][j] = 0.f;

  const T* bp = B + g * bs.g + h * bs.h;
  const T* xp = x + g * xs.g + h * xs.h;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BT;
    // 3a. stage B_t and x_t (zero past the chunk and past p).
    for (int i = tid; i < BT * N; i += THREADS) {
      const int r = i / N, c = i % N, s = k0 + r;
      bk[r * ldn + c] = s < CL ? to_f32(bp[(long long)s * bs.l + c]) : 0.f;
    }
    for (int i = tid; i < BT * XC; i += THREADS) {
      const int r = i / XC, c = i % XC, s = k0 + r;
      xk[i] = (s < CL && c < P) ? to_f32(xp[(long long)s * xs.l + c]) : 0.f;
    }
    __syncthreads();

    // 3b. scores = C_q . B_t^T, then the decay mask, into shared memory.
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = cq[(ty + 16 * i) * ldn + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bk[(tx + 16 * j) * ldn + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, l = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, s = k0 + c;
        const bool vis = s <= l && l < CL && s < CL;
        ss[r * (BT + 1) + c] = vis ? acc[i][j] * expf(cs[l] - cs[s]) : 0.f;
      }
    }
    __syncthreads();

    // 3c. y += scores . x_t
#pragma unroll 4
    for (int s = 0; s < BT; ++s) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ss[(ty + 16 * i) * (BT + 1) + s];
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const float xv = xk[s * XC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i][j] = fmaf(a[i], xv, y[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + ty + 16 * i;
    if (l >= CL) continue;
    T* op = out + (((long long)g * CL + l) * H + h) * P;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int c = tx + 16 * j;
      if (c < P) op[c] = from_f32<T>(y[i][j]);
    }
  }
}

template <int PJ, typename T>
cudaError_t launch(const T* x, const T* dA, const T* B, const T* C, T* out,
                   int G, int CL, int H, int P, int N, Str3 xs, Str3 bs,
                   Str3 cs, Str3 das, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, PJ);
  static size_t smem_set = 0;  // per instantiation: raise the cap once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<PJ, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid((CL + BT - 1) / BT, H, G);
  ssd_intra_chunk_kernel<PJ, T><<<grid, THREADS, smem, stream>>>(
      x, dA, B, C, out, CL, H, P, N, xs, bs, cs, das);
  return cudaGetLastError();
}

}  // namespace

// x (G, CL, H, P), dA (G, CL, H), B and C (G, CL, H, N): strides of their
// first three dims in elements (last dim contiguous); out contiguous
// (G, CL, H, P).  All in one dtype (dt: 0 fp32, 1 bf16).
extern "C" int ssd_intra_chunk(const void* x, const void* dA, const void* B,
                               const void* C, void* out, int dt, int G, int CL,
                               int H, int P, int N, long long x_sg,
                               long long x_sl, long long x_sh, long long b_sg,
                               long long b_sl, long long b_sh, long long c_sg,
                               long long c_sl, long long c_sh, long long d_sg,
                               long long d_sl, long long d_sh, void* stream) {
  if (G <= 0 || CL <= 0 || CL > MAX_CL || H <= 0 || P <= 0 || P > 128 ||
      N <= 0 || N > 256)
    return (int)cudaErrorInvalidValue;
  const Str3 xs{x_sg, x_sl, x_sh}, bs{b_sg, b_sl, b_sh}, cs{c_sg, c_sl, c_sh},
      das{d_sg, d_sl, d_sh};
  cudaError_t err = cudaErrorInvalidValue;
  with_dtype(dt, [&](auto* tp) {
    using T = elem_t<decltype(tp)>;
    auto go = [&](auto pj) {
      constexpr int PJ = decltype(pj)::value;
      err = launch<PJ, T>(static_cast<const T*>(x), static_cast<const T*>(dA),
                          static_cast<const T*>(B), static_cast<const T*>(C),
                          static_cast<T*>(out), G, CL, H, P, N, xs, bs, cs, das,
                          (cudaStream_t)stream);
    };
    if (P <= 16) go(Int<1>{});
    else if (P <= 32) go(Int<2>{});
    else if (P <= 64) go(Int<4>{});
    else go(Int<8>{});
  });
  return (int)err;
}
