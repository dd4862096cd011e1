// Grouped and ragged expert GEMMs for Hopper (sm_90a) on the CUDA cores,
// fp32 FMA with fp32 accumulation: the designs for fp32 weights (design
// fma), the fused ragged gate-up-SiLU included.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/moe_gemm/moe_gemm.py:
//   grouped_matmul_f32       (:67,  body _matmul_kernel :45) and
//   ragged_matmul_f32        (:178, body _ragged_mm_kernel :154) where the
//                            weights are fp32 (design fma: the card's fp32
//                            parity runs); bf16 weights, as on the serving
//                            and training paths, go to the tensor-core
//                            kernels of moe_gemm_tc.cu
//   ragged_gate_up_silu_f32  (:253, body _ragged_gate_up_kernel :225),
//                            likewise for fp32 weights
// (ragged_dw_f32, :335, runs on the tensor cores for every operand pair:
// moe_gemm_tc.cu.)
//
// What bounds them on an H100: the expert weights.  At granite-moe-3b's
// widths (d=1536, expert d_ff=512, 40 experts) a decode step has ~1 row per
// expert, so every launch is a stream over E*K*N weight bytes (memory bound,
// 3.35 TB/s); a 512-token prefill has ~100 rows per expert, which puts it
// near the ridge of the card's fp32 CUDA-core rate.
//
// Design (first, simple version): one 256-thread block computes a BM x 64
// output tile, looping over K in 32-deep slabs staged through shared memory
// as fp32 (bf16 operands are widened on load), each thread owning a
// (BM/16) x 4 register tile.  All arithmetic is fp32 FMA on the CUDA cores,
// so fp32 inputs keep full fp32 precision (no TF32).  In these kernels each
// output element is summed over k in ascending order whatever the tile
// shape, so a row's result does not depend on which other rows share its
// launch.  BM is 16 for skinny launches (decode) and 64 otherwise.  These
// kernels use neither tensor cores nor TMA (moe_gemm_tc.cu uses mma.sync
// and cp.async).
//
// The TPU grid walks (tile, expert) work items in order and blend-stores
// tiles that straddle an expert boundary into a VMEM-resident block.  Here
// blocks run in parallel: one block takes one work item x one N tile, masks
// its rows to [offsets[e], offsets[e+1]) on load and on store, so the
// stores of two items sharing a row tile are disjoint and no ordering rule
// is needed.  Surplus work items (valid == 0) exit at once.  Rows no expert
// owns are never written: the wrapper hands in a zeroed output.

#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

// acc[j][m][c] += sum_k x[row0 + ty*TM + m][k] * w[j][k][col0 + tx*4 + c]
// for rows in [row_lo, row_hi) (other rows read as 0) and NW weight mats.
template <int BM, int NW, typename TX, typename TW>
__device__ __forceinline__ void gemm_tile(
    const TX* __restrict__ x, int row0, int row_lo, int row_hi, int K,
    const TW* const (&w)[NW], int N, int col0, float (&acc)[NW][BM / 16][4]) {
  constexpr int TM = BM / 16;
  __shared__ float xs[BK][BM + 1];  // +1: the transposing store is conflict-free
  __shared__ __align__(16) float ws[NW][BK][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK, row = row0 + r, k = k0 + kk;
      float v = 0.f;
      if (row >= row_lo && row < row_hi && k < K) v = to_f32(x[(size_t)row * K + k]);
      xs[kk][r] = v;
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, c = i % BN, k = k0 + kk, col = col0 + c;
        ws[j][kk][c] = (k < K && col < N) ? to_f32(w[j][(size_t)k * N + col]) : 0.f;
      }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = xs[kk][ty * TM + m];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(&ws[j][kk][tx * 4]);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          acc[j][m][0] = fmaf(a[m], b.x, acc[j][m][0]);
          acc[j][m][1] = fmaf(a[m], b.y, acc[j][m][1]);
          acc[j][m][2] = fmaf(a[m], b.z, acc[j][m][2]);
          acc[j][m][3] = fmaf(a[m], b.w, acc[j][m][3]);
        }
      }
    }
    __syncthreads();
  }
}

template <int BM, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
grouped_mm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  float* __restrict__ out, int M, int K, int N) {
  constexpr int TM = BM / 16;
  const int e = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const TW* const we[1] = {w + (size_t)e * K * N};
  float acc[1][TM][4];
  gemm_tile<BM, 1>(x + (size_t)e * M * K, row0, 0, M, K, we, N, col0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int row = row0 + ty * TM + m;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx * 4 + c;
      if (col < N) out[((size_t)e * M + row) * N + col] = acc[0][m][c];
    }
  }
}

// One block = one (row tile, expert) work item x one N tile.  NW = 1 is the
// ragged GEMM (out0 = x @ w0); NW = 2 is the fused gate-up-SiLU
// (out0 = h = silu(x@w0) * (x@w1), out1 = x@w0, out2 = x@w1).
template <int BM, int NW, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
ragged_kernel(const TX* __restrict__ x, const TW* __restrict__ w0,
              const TW* __restrict__ w1, const int* __restrict__ offsets,
              const int* __restrict__ tile_m, const int* __restrict__ grp,
              const int* __restrict__ valid, float* __restrict__ out0,
              float* __restrict__ out1, float* __restrict__ out2, int T, int K,
              int N) {
  constexpr int TM = BM / 16;
  const int g = blockIdx.y;
  if (!valid[g]) return;  // surplus item: uniform per block, before any sync
  const int e = grp[g];
  const int lo = offsets[e], hi = min(offsets[e + 1], T);
  const int row0 = tile_m[g] * BM, col0 = blockIdx.x * BN;
  if constexpr (NW == 2) {
    const TW* const ws[2] = {w0 + (size_t)e * K * N, w1 + (size_t)e * K * N};
    float acc[2][TM][4];
    gemm_tile<BM, 2>(x, row0, lo, hi, K, ws, N, col0, acc);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int row = row0 + ty * TM + m;
      if (row < lo || row >= hi) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + tx * 4 + c;
        if (col >= N) continue;
        const float ag = acc[0][m][c], au = acc[1][m][c];
        const size_t o = (size_t)row * N + col;
        out0[o] = ag / (1.f + expf(-ag)) * au;
        out1[o] = ag;
        out2[o] = au;
      }
    }
  } else {
    const TW* const ws[1] = {w0 + (size_t)e * K * N};
    float acc[1][TM][4];
    gemm_tile<BM, 1>(x, row0, lo, hi, K, ws, N, col0, acc);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int row = row0 + ty * TM + m;
      if (row < lo || row >= hi) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + tx * 4 + c;
        if (col < N) out0[(size_t)row * N + col] = acc[0][m][c];
      }
    }
  }
}

// f(Int<BM>, const TX*, const TW*) for the runtime (bm, x dtype, w dtype);
// false if any of the three is not supported.
template <typename F> bool dispatch(int bm, int xdt, int wdt, F&& f) {
  auto known = [](int code) { return code == kF32 || code == kBF16; };
  if ((bm != 16 && bm != 64) || !known(xdt) || !known(wdt)) return false;
  auto by_bm = [&](auto bmt) {
    with_dtype(xdt, [&](auto* xp) {
      with_dtype(wdt, [&](auto* wp) { f(bmt, xp, wp); });
    });
  };
  if (bm == 16) by_bm(Int<16>{});
  else by_bm(Int<64>{});
  return true;
}

}  // namespace

extern "C" int grouped_matmul_f32_fma(const void* x, int xdt, const void* w, int wdt,
                                      void* out, int E, int M, int K, int N, int bm,
                                      void* stream) {
  const bool ok = dispatch(bm, xdt, wdt, [&](auto bmt, auto* xp, auto* wp) {
    using TX = elem_t<decltype(xp)>;
    using TW = elem_t<decltype(wp)>;
    constexpr int BM = decltype(bmt)::value;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
    grouped_mm_kernel<BM, TX, TW><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<float*>(out), M, K, N);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

static int ragged_launch(int nw, const void* x, int xdt, const void* w0,
                         const void* w1, int wdt, const int* offsets,
                         const int* tile_m, const int* grp, const int* valid,
                         void* out0, void* out1, void* out2, int T, int K, int N,
                         int G, int bm, void* stream) {
  if (G <= 0) return (int)cudaErrorInvalidValue;
  const bool ok = dispatch(bm, xdt, wdt, [&](auto bmt, auto* xp, auto* wp) {
    using TX = elem_t<decltype(xp)>;
    using TW = elem_t<decltype(wp)>;
    constexpr int BM = decltype(bmt)::value;
    const dim3 grid((N + BN - 1) / BN, G);
    auto args = [&](auto kernel) {
      kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w0),
          static_cast<const TW*>(w1), offsets, tile_m, grp, valid,
          static_cast<float*>(out0), static_cast<float*>(out1),
          static_cast<float*>(out2), T, K, N);
    };
    if (nw == 2) args(ragged_kernel<BM, 2, TX, TW>);
    else args(ragged_kernel<BM, 1, TX, TW>);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ragged_matmul_f32(const void* x, int xdt, const void* w, int wdt,
                                 const int* offsets, const int* tile_m,
                                 const int* grp, const int* valid, void* out,
                                 int T, int K, int N, int G, int bm,
                                 void* stream) {
  return ragged_launch(1, x, xdt, w, w, wdt, offsets, tile_m, grp, valid, out,
                       nullptr, nullptr, T, K, N, G, bm, stream);
}

extern "C" int ragged_gate_up_silu_f32(const void* x, int xdt, const void* w_gate,
                                       const void* w_up, int wdt,
                                       const int* offsets, const int* tile_m,
                                       const int* grp, const int* valid, void* h,
                                       void* a_g, void* a_u, int T, int K, int F,
                                       int G, int bm, void* stream) {
  return ragged_launch(2, x, xdt, w_gate, w_up, wdt, offsets, tile_m, grp, valid,
                       h, a_g, a_u, T, K, F, G, bm, stream);
}
