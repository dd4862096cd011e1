// Grouped expert GEMM on Hopper's tensor cores (sm_90a): the bf16-weight
// paths of grouped_matmul_f32, out[e] = x[e] @ w[e] with fp32 sums and
// output, x (E, M, K) bf16 or fp32, w (E, K, N) bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gemm/moe_gemm.py:67
// grouped_matmul_f32 (body _matmul_kernel :45) where the weights are bf16,
// as on the serving path; fp32 weights keep grouped_mm_kernel in
// moe_gemm.cu (fp32 FMA, no TF32).  The wrapper chooses by (x dtype,
// w dtype, M), never because a launch failed.
//
// What bounds it on an H100: bytes.  At granite-moe-3b's capacity serving
// shapes (40 experts, d = 1536, d_ff = 512) a 512-token prefill has C = 128
// rows per expert: 8.05 GFLOP per launch against ~79 MB of x, w and out,
// 0.008 ms of bf16 tensor-core work against 0.024-0.031 ms of HBM traffic;
// a decode step has C = 1 and is a stream of the 63 MB of expert weights
// (0.019 ms at 3.35 TB/s).  So bf16 mma.sync (m16n8k16) has the arithmetic
// rate to reach the bound; wgmma's higher rate matters above the ridge.
//
// Design: one block per (N tile, M tile, expert).  Operand tiles travel
// global -> shared by 16-byte cp.async through a 4-stage ring (no
// registers, no wait on a slab before the next is in flight), rows padded
// by 16 bytes so ldmatrix reads are free of bank conflicts; x rows past M
// and k past K are zero-filled on load, stores are masked.  Tile shapes,
// tuned by x dtype and M from timings on the card (see Tile128 below); the
// wrapper picks one (grouped_tile in kernels/moe_gemm/ops.py, the only
// place that routes) and passes its code to the one entry point:
//   Tile128 (design tc, bf16 x, M > 64): 128 x 64 output tile, 32-deep k
//       slabs, 8 warps each a 32 x 32 sub-tile (2 x 4 mma tiles); at the
//       512 bucket's C = 128 one block holds all of an expert's rows, so
//       each weight tile leaves L2 once;
//   Tile64 (tc, bf16 x with 16 < M <= 64) and Tile64Split (tc, fp32 x):
//       64 x 64 tile, 4 warps (for fp32 x stacked along M: the split is
//       done once per fragment);
//   Skinny (design skinny, M <= 16, decode): 16 x 64 tile, 4 warps, 64-deep
//       k slabs, each
//       warp 16 columns, so three 8 KB weight slabs are in flight per block;
//       the decode grids (320 and 960 blocks at ~46-55 KB of shared memory,
//       up to 4 per SM) are resident in one wave, so no second wave is left
//       near-empty.
// These kernels issue many instructions per mma (copies, ldmatrix, the
// split, the promotion below), and on the card that, not bytes, holds the
// prefill tiles at ~2x their bound; wgmma would cut it.
// fp32 x (the down projection's hidden activation) is split, as its
// fragments are read from shared memory, into three bf16 pieces
// hi + mid + lo that sum to x exactly (split_bf16x3); three mma against the
// same w fragment then form x * w from exact products.  The tensor cores'
// accumulator does not round to nearest, so each run of 32-128 k is summed
// apart and added to an fp32 register total with ordinary adds; the result
// differs from the fp32 product by summation order and that run's
// truncation (held at rtol 2e-5 / atol 1.6e-4 on the card).  Output rows are
// independent of one another (no row's result depends on which rows share
// its launch) and every run sums in the same order: no atomics, no split-K.

#include "common.cuh"
#include "mma.cuh"

namespace {

// BM x BN output tile, BK-deep slabs, STAGES-deep ring, WM x WN per warp,
// PK-deep runs of k summed apart on the tensor cores (see `part`), at least
// MINB blocks resident per SM (a register cap for the compiler).
template <int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_, int PK_, int MINB_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_, WM = WM_, WN = WN_;
  static constexpr int PK = PK_, MINB = MINB_, THREADS = 32 * (BM / WM) * (BN / WN);
};
// Chosen on the card (H100, 40 experts at granite's widths, M = 32..128):
// bf16 x with M > 64 rows: 8 warps, three blocks an SM (<= 85 registers),
// so the 320 blocks of a 512-bucket gate/up launch are one wave; the sum
// is promoted every slab, the depth that spilled least under that cap.
using Tile128 = Shape<128, 64, 32, 4, 32, 32, 32, 3>;
// bf16 x with 16 < M <= 64: 4 warps (with 8, half the rows of Tile128
// took as long as all of them).
using Tile64 = Shape<64, 64, 32, 4, 32, 32, 128, 4>;
// fp32 x (three bf16 pieces, 3x the mma; an 8-warp tile held one block an
// SM at ~140 registers): 4 warps stacked along M, each 16 rows x 64
// columns, so each x fragment is split once a block rather than once per
// warp column; two blocks an SM, promoted every 64 k.
using Tile64Split = Shape<64, 64, 32, 4, 16, 64, 64, 2>;
// M <= 16 (decode): the weight stream, 4 warps of 16 columns.
using Skinny = Shape<16, 64, 64, 4, 16, 16, 64, 1>;

template <typename S, typename TX> constexpr int smem_bytes() {
  return S::STAGES * (S::BM * (S::BK + 8) * (int)sizeof(TX) + S::BK * (S::BN + 8) * 2);
}

template <typename S, typename TX>
__global__ void __launch_bounds__(S::THREADS, S::MINB)
grouped_tc_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                  float* __restrict__ out, int M, int K, int N) {
  constexpr int BM = S::BM, BN = S::BN, BK = S::BK, STAGES = S::STAGES, THREADS = S::THREADS;
  constexpr int PK = S::PK;
  constexpr int WM = S::WM, WN = S::WN, MI = WM / 16, NI = WN / 8;
  constexpr int WARPS_N = BN / WN;
  static_assert(NI % 2 == 0, "n tiles go in pairs (one ldmatrix.x4.trans)");
  constexpr bool SPLIT = std::is_same<TX, float>::value;
  constexpr int XLD = BK + 8, WLD = BN + 8;  // +16 bytes a row: conflict-free ldmatrix
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem);                                    // [STAGES][BM][XLD]
  bf16* ws = reinterpret_cast<bf16*>(smem + STAGES * BM * XLD * sizeof(TX));  // [STAGES][BK][WLD]

  const int e = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const TX* xe = x + (size_t)e * M * K;
  const bf16* we = w + (size_t)e * K * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / WARPS_N) * WM, wc = (warp % WARPS_N) * WN;

  // Each thread's 16-byte copy slots: their rows and columns are fixed for
  // the whole K loop, so only the k offset moves from slab to slab.
  constexpr int EPC = 16 / sizeof(TX), XC = BK / EPC, NX = BM * XC / THREADS;
  constexpr int WC = BN / 8, NW = BK * WC / THREADS;
  static_assert(NX * THREADS == BM * XC && NW * THREADS == BK * WC, "whole chunks a thread");
  const TX* x_src[NX];
  const bf16* w_src[NW];
  int x_dst[NX], x_k[NX], w_dst[NW], w_k[NW];
  bool x_ok[NX], w_ok[NW];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int i = tid + j * THREADS, r = i / XC, c = (i % XC) * EPC;
    x_ok[j] = row0 + r < M;
    x_src[j] = xe + (size_t)(x_ok[j] ? row0 + r : 0) * K + c;
    x_dst[j] = r * XLD + c;
    x_k[j] = c;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int i = tid + j * THREADS, r = i / WC, c = (i % WC) * 8;
    w_ok[j] = col0 + c < N;
    w_src[j] = we + (size_t)r * N + (w_ok[j] ? col0 + c : 0);
    w_dst[j] = r * WLD + c;
    w_k[j] = r;
  }
  auto load_stage = [&](int st, int k0) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const bool ok = x_ok[j] && x_k[j] + k0 < K;
      cp_async16(xs + st * BM * XLD + x_dst[j], ok ? x_src[j] + k0 : xe, ok);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const bool ok = w_ok[j] && w_k[j] + k0 < K;
      cp_async16(ws + st * BK * WLD + w_dst[j], ok ? w_src[j] + (size_t)k0 * N : we, ok);
    }
  };

  // The tensor cores add each product into their accumulator without
  // rounding to nearest (the low bits are cut), a bias of up to an ulp of
  // the running sum per mma.  So every PK-deep run of k sums into a fresh
  // `part`, which is then added to `acc` by ordinary fp32 adds (round to
  // nearest): the bias stays that of PK/16 mma (x 3 pieces), not of K/16.
  constexpr int PS = PK / BK;  // slabs a part spans
  static_assert(PS * BK == PK, "PK a multiple of BK");
  float acc[MI][NI][4], part[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // slab kt has landed
    __syncthreads();              // ... for all threads; slab kt-1 is consumed
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const TX* xt = xs + (kt % STAGES) * BM * XLD;
    const bf16* wt = ws + (kt % STAGES) * BK * WLD;
    if (kt % PS == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mi][ni][c] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      constexpr int P = SPLIT ? 3 : 1;  // bf16 pieces of each x value
      uint32_t a[MI][P][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wr + mi * 16;
        if constexpr (SPLIT) {
          const float* p = xt + (r + g) * XLD + kk + 2 * t;
          const float* q[4] = {p, p + 8 * XLD, p + 8, p + 8 * XLD + 8};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_bf16x3(*reinterpret_cast<const float2*>(q[j]), a[mi][0][j], a[mi][1][j],
                         a[mi][2][j]);
        } else {
          ldmatrix_x4(a[mi][0], xt + (r + (lane & 15)) * XLD + kk + (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wt + (kk + (lane & 15)) * WLD + wc + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            mma_bf16(part[mi][2 * np], a[mi][p], b[0], b[1]);
            mma_bf16(part[mi][2 * np + 1], a[mi][p], b[2], b[3]);
          }
      }
    }
    if (kt % PS == PS - 1 || kt == KT - 1) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[mi][ni][c];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int row = row0 + wr + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = col0 + wc + ni * 8 + 2 * t;  // N % 8 == 0: col < N covers col + 1
      if (col >= N) continue;
      float* o = out + ((size_t)e * M + row) * N + col;
      if (row < M) *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(o + 8 * (size_t)N) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

template <typename S, typename TX>
int launch(const void* x, const void* w, void* out, int E, int M, int K, int N, void* stream) {
  constexpr int SMEM = smem_bytes<S, TX>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_tc_kernel<S, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + S::BN - 1) / S::BN, (M + S::BM - 1) / S::BM, E);
  grouped_tc_kernel<S, TX><<<grid, S::THREADS, SMEM, (cudaStream_t)stream>>>(
      static_cast<const TX*>(x), static_cast<const bf16*>(w), static_cast<float*>(out), M, K,
      N);
  return (int)cudaGetLastError();
}

// 16-byte rows for cp.async: K a multiple of 8 (bf16 x) or 4 (fp32 x), N of 8.
bool shapes_ok(int xdt, int E, int M, int K, int N) {
  return E > 0 && M > 0 && K > 0 && N > 0 && N % 8 == 0 &&
         ((xdt == kBF16 && K % 8 == 0) || (xdt == kF32 && K % 4 == 0));
}

}  // namespace

// Tile codes, as TILES in kernels/moe_gemm/ops.py lists them.
enum Tile { kTile128 = 0, kTile64 = 1, kTile64Split = 2, kSkinny = 3 };

extern "C" int grouped_matmul_f32_tc(const void* x, int xdt, const void* w, void* out, int E,
                                     int M, int K, int N, int tile, void* stream) {
  if (!shapes_ok(xdt, E, M, K, N)) return (int)cudaErrorInvalidValue;
  if (xdt == kF32) {
    if (tile == kTile64Split) return launch<Tile64Split, float>(x, w, out, E, M, K, N, stream);
    if (tile == kSkinny) return launch<Skinny, float>(x, w, out, E, M, K, N, stream);
  } else {
    if (tile == kTile128) return launch<Tile128, bf16>(x, w, out, E, M, K, N, stream);
    if (tile == kTile64) return launch<Tile64, bf16>(x, w, out, E, M, K, N, stream);
    if (tile == kSkinny) return launch<Skinny, bf16>(x, w, out, E, M, K, N, stream);
  }
  return (int)cudaErrorInvalidValue;  // a tile not built for this x dtype
}
