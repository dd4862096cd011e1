// Grouped and ragged expert GEMMs on Hopper's tensor cores (sm_90a), fp32
// sums and output:
//   grouped_matmul_f32_tc  out[e] = x[e] @ w[e], x (E, M, K) bf16 or fp32,
//                          w (E, K, N) bf16;
//   ragged_matmul_f32_tc   out[t] = x[t] @ w[expert(t)] for expert-sorted
//                          rows x (T, K) bf16 or fp32, w (E, K, N) bf16;
//   ragged_gate_up_silu_f32_tc
//                          (h, a_g, a_u) = (silu(a_g) * a_u, x[t] @ Wg[e],
//                          x[t] @ Wu[e]) on the same rows, Wg, Wu bf16;
//   ragged_dw_f32_tc       dW[e] = x_e^T @ g_e, x (T, K), g (T, N), each
//                          bf16 or fp32, dW (E, K, N) fp32.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/moe_gemm/moe_gemm.py
//   grouped_matmul_f32 (:67, body _matmul_kernel :45) and ragged_matmul_f32
//   (:178, body _ragged_mm_kernel :154) and ragged_gate_up_silu_f32 (:253,
//   body _ragged_gate_up_kernel :225) where the weights are bf16, as on the
//   serving and training paths (fp32 weights keep the fp32 FMA kernels of
//   moe_gemm.cu, no TF32), and ragged_dw_f32 (:335, body _ragged_dw_kernel
//   :310) for every operand pair.  The wrappers in
//   kernels/moe_gemm/ops.py choose the design and tile by (x dtype,
//   w dtype, rows per expert), never because a launch failed.
//
// What bounds them on an H100: bytes, given the tensor cores.  At
// granite-moe-3b's widths (40 experts, d = 1536, d_ff = 512) a 512-token
// capacity prefill (C = 128 rows an expert) is 8.05 GFLOP against ~79 MB,
// 0.008 ms of bf16 mma against 0.024-0.031 ms of HBM traffic; a decode step
// streams the 63 MB of expert weights (0.019 ms at 3.35 TB/s).  The ragged
// down projection of a 4096-row prefill is 6.4 GFLOP (19 as three bf16
// pieces, 0.020 ms) against ~96 MB (0.029 ms), its fused gate-up 12.9
// GFLOP of bf16 mma (0.013 ms) against ~164 MB, mostly the three fp32
// outputs (0.049 ms); the dgrad of 8192 rows
// writes 126 MB of fp32 dW alone (0.038 ms) against 3 x 12.9 GFLOP (0.039
// ms) for bf16 x, 6 x for fp32 pairs (0.078 ms).  So bf16 mma.sync
// (m16n8k16) has the rate to approach the bound; wgmma's higher rate
// matters above the ridge.
//
// Forward design (grouped and ragged share one tile body, `tc_tile`): one
// block computes a BM x BN output tile from a row window [lo, hi) of x and
// one expert's weights.  The grouped kernel is one block per (N tile, M
// tile, expert) with the window [0, M) of expert e's buffer; the ragged
// kernels are one block per (N tile, work item) of the (tile, expert) table
// built by ops.ragged_metadata at the tile's BM, with the window
// [offsets[e], min(offsets[e+1], T)): a row tile straddling experts is one
// item per expert, its stores masked to the window, so items sharing a
// tile write disjoint rows (no ordering rule, no atomics); surplus items
// (valid = 0) exit before the first barrier, and rows no expert owns keep
// the wrapper's zeros.  An expert's items are adjacent on the grid, so its
// weight slabs are served from L2 after the first item.  Operand tiles
// travel global -> shared by 16-byte cp.async through a 4-stage ring (no
// registers, no wait on a slab before the next is in flight), rows padded
// by 16 bytes so ldmatrix reads are free of bank conflicts; x rows outside
// the window and k past K are zero-filled on load (src-size 0), stores are
// masked.  Tile shapes, tuned by x dtype and rows per expert on the card
// (see Tile128 below); the wrapper picks one (grouped_tile / ragged_tile in
// kernels/moe_gemm/ops.py, the only place that routes) and passes its code:
//   Tile128 (design tc, bf16 x, grouped M > 64): 128 x 64 output tile,
//       32-deep k slabs, 8 warps each a 32 x 32 sub-tile (2 x 4 mma tiles);
//       at the 512 bucket's C = 128 one block holds all of an expert's rows,
//       so each weight tile leaves L2 once;
//   Tile64 (tc, bf16 x with 16 < rows <= 64, and ragged bf16 x) and
//       Tile64Split (tc, fp32 x): 64 x 64 tile, 4 warps (for fp32 x stacked
//       along M: the split is done once per fragment);
//   Skinny (design skinny, rows <= 16, decode): 16 x 64 tile, 4 warps,
//       64-deep k slabs, each warp 16 columns, so three 8 KB weight slabs
//       are in flight per block; the decode grids (320 and 960 blocks at
//       ~46-55 KB of shared memory, up to 4 per SM) are resident in one
//       wave, so no second wave is left near-empty.
// The fused gate-up (ragged_tc_kernel with OPS = 2) runs on the same tiles
// and work tables: its weight slab holds 8-column blocks of Wg and Wu in
// turn, so BN slab columns are BN / 2 output columns of both, x's
// fragments (or their three pieces) feed the gate and the up mma of the
// same k step (x is read once for both), and each thread forms h =
// silu(a_g) * a_u in registers from its own accumulators.
// These kernels issue many instructions per mma (copies, ldmatrix, the
// split, the promotion below), and on the card that, not bytes, holds the
// prefill and training tiles at ~2-5x their bound; wgmma would cut it.
//
// Dgrad design (ragged_dw_tc_kernel): one block per (64-wide N tile,
// 128-wide K tile, expert) walks its expert's rows [offsets[e], offsets[e+1])
// (read on the device: no work table, no host sync) in 32-row slabs, in
// order: the contraction is over rows, so A = x^T comes from the [rows][K]
// slab and B = g from the [rows][N] slab, both by ldmatrix.trans.  One block
// owns one output tile and sums its rows in a fixed order: deterministic,
// no split over rows, no atomics, zeros written for an expert with no rows.
// Rows outside the expert (and past T) are zero-filled in BOTH operands by
// cp.async with src-size 0, before any split, so 0 * NaN is never formed.
// An fp32 operand lands raw in its ring and is split once, after it lands,
// into three bf16 planes (hi, mid, lo) in shared memory (one barrier), from
// which ldmatrix.trans reads its fragments (fp32 fragments would pair two
// rows of one column: two scalar loads a row apart, with bank conflicts).
//
// fp32 operands on the tensor cores: split_bf16x3 cuts an fp32 value into
// bf16 pieces hi + mid + lo that sum to it exactly; the product of two bf16
// pieces is exact in fp32.  fp32 x against bf16 w (or a bf16 dgrad operand
// against an fp32 one) takes the three products of the pieces, all exact;
// an fp32 x fp32 dgrad pair keeps the six products hi.hi, hi.mid, mid.hi,
// hi.lo, mid.mid, lo.hi and drops the three below 2^-24 of |x.g|.  The
// tensor cores' accumulator does not round to nearest, so each run of
// 32-128 k (dgrad: 64 rows) is summed apart (`part`) and added to an fp32
// register total with ordinary adds; the result differs from the fp32
// product by summation order and that run's truncation (held at rtol 2e-5 /
// atol 1.6e-4 on the card).  Output rows are independent of one another (no
// row's result depends on which rows share its launch) and every run sums
// in the same order: no atomics, no split-K.

#include "common.cuh"
#include "mma.cuh"

namespace {

// BM x BN output tile, BK-deep slabs (dgrad: BK rows), STAGES-deep ring,
// WM x WN per warp, PK-deep runs of k summed apart on the tensor cores (see
// `part`), at least MINB blocks resident per SM (a register cap for the
// compiler).
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
// The fused gate-up's tile for bf16 x where ragged_tile picks Tile64: 64
// rows x 128 slab columns (64 output columns of gate and up), 8 warps of
// Tile64's warp tile.  Timed on the card against Tile64 itself (32 output
// columns): 7-8 % faster at prefill and training, x being read from L2 half
// as often; at decode the same widening of Skinny was 2 % slower, so the
// gate-up's skinny and fp32-x tiles are the ragged GEMM's.
using Tile64Pair = Shape<64, 128, 32, 4, 32, 32, 128, 2>;
// Dgrad, timed on the card against 64 x 64 (4 warps), 128 x 64 with 4 warps
// of 64 x 32 and 128 x 128 (16 warps): 128 (k) x 64 (n) outputs, 32-row
// slabs in a 3-stage ring, 8 warps of 32 x 32, runs of 64 rows summed
// apart; two blocks an SM (<= 128 registers; ~111 KB of rings and planes
// for an fp32 pair).  Each fp32 g slab is split once per 128 k, not 64.
using DwTile = Shape<128, 64, 32, 3, 32, 32, 64, 2>;

template <typename S, typename TX> constexpr int smem_bytes() {
  return S::STAGES * (S::BM * (S::BK + 8) * (int)sizeof(TX) + S::BK * (S::BN + 8) * 2);
}

// For the rows of the tile at (row0, col0) that lie in [lo, hi), with x
// (rows, K) and the outputs (rows, N) indexed by absolute row and w0, w1
// one expert's (K, N) weights; other rows of x read as 0 and are not stored.
// OPS = 1: out0 = x . w0 over BM x BN outputs (w1, out1, out2 unused).
// OPS = 2, the fused gate-up-SiLU over BM x BN/2 outputs: out0 = h =
// silu(a_g) * a_u, out1 = a_g = x . w0, out2 = a_u = x . w1.  The weight
// slab interleaves 8-column blocks of w0 and w1, so the two n tiles of each
// ldmatrix.x4.trans are gate and up of the same 8 output columns: each
// thread holds a_g and a_u of the same (row, column) in its accumulators
// and forms h in registers, with no exchange through shared memory.
template <typename S, int OPS, typename TX>
__device__ __forceinline__ void tc_tile(const TX* __restrict__ x, int row0, int lo, int hi,
                                        int K, const bf16* __restrict__ w0,
                                        const bf16* __restrict__ w1, int N, int col0,
                                        float* __restrict__ out0, float* __restrict__ out1,
                                        float* __restrict__ out2, unsigned char* smem) {
  static_assert(OPS == 1 || OPS == 2, "one weight operand, or gate and up");
  constexpr int BM = S::BM, BN = S::BN, BK = S::BK, STAGES = S::STAGES, THREADS = S::THREADS;
  constexpr int PK = S::PK;
  constexpr int WM = S::WM, WN = S::WN, MI = WM / 16, NI = WN / 8;
  constexpr int WARPS_N = BN / WN;
  static_assert(NI % 2 == 0, "n tiles go in pairs (one ldmatrix.x4.trans)");
  constexpr bool SPLIT = std::is_same<TX, float>::value;
  constexpr int XLD = BK + 8, WLD = BN + 8;  // +16 bytes a row: conflict-free ldmatrix
  TX* xs = reinterpret_cast<TX*>(smem);                                    // [STAGES][BM][XLD]
  bf16* ws = reinterpret_cast<bf16*>(smem + STAGES * BM * XLD * sizeof(TX));  // [STAGES][BK][WLD]

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
    x_ok[j] = row0 + r >= lo && row0 + r < hi;
    x_src[j] = x + (size_t)(x_ok[j] ? row0 + r : 0) * K + c;
    x_dst[j] = r * XLD + c;
    x_k[j] = c;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    // slab chunk ci: operand ci % OPS, output columns (ci / OPS) * 8 ..
    const int i = tid + j * THREADS, r = i / WC, ci = i % WC, c = (ci / OPS) * 8;
    w_ok[j] = col0 + c < N;
    w_src[j] = (ci % OPS ? w1 : w0) + (size_t)r * N + (w_ok[j] ? col0 + c : 0);
    w_dst[j] = r * WLD + ci * 8;
    w_k[j] = r;
  }
  auto load_stage = [&](int st, int k0) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const bool ok = x_ok[j] && x_k[j] + k0 < K;
      cp_async16(xs + st * BM * XLD + x_dst[j], ok ? x_src[j] + k0 : x, ok);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const bool ok = w_ok[j] && w_k[j] + k0 < K;
      cp_async16(ws + st * BK * WLD + w_dst[j], ok ? w_src[j] + (size_t)k0 * N : w0, ok);
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

  if constexpr (OPS == 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int row = row0 + wr + mi * 16 + g;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = col0 + wc + ni * 8 + 2 * t;  // N % 8 == 0: col < N covers col + 1
        if (col >= N) continue;
        float* o = out0 + (size_t)row * N + col;
        if (row >= lo && row < hi)
          *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        if (row + 8 >= lo && row + 8 < hi)
          *reinterpret_cast<float2*>(o + 8 * (size_t)N) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  } else {
    // n tiles 2j (gate) and 2j + 1 (up) cover output columns wc / 2 + 8 j ..
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        const int col = col0 + wc / 2 + (ni / 2) * 8 + 2 * t;
        if (col >= N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows g and g + 8 of the mma tile
          const int row = row0 + wr + mi * 16 + g + 8 * half;
          if (row < lo || row >= hi) continue;
          const size_t o = (size_t)row * N + col;
          const float2 a = make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
          const float2 u =
              make_float2(acc[mi][ni + 1][2 * half], acc[mi][ni + 1][2 * half + 1]);
          *reinterpret_cast<float2*>(out0 + o) =
              make_float2(a.x / (1.f + expf(-a.x)) * u.x, a.y / (1.f + expf(-a.y)) * u.y);
          *reinterpret_cast<float2*>(out1 + o) = a;
          *reinterpret_cast<float2*>(out2 + o) = u;
        }
      }
    }
  }
}

template <typename S, typename TX>
__global__ void __launch_bounds__(S::THREADS, S::MINB)
grouped_tc_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                  float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.z;
  const bf16* we = w + (size_t)e * K * N;
  float* oe = out + (size_t)e * M * N;
  tc_tile<S, 1>(x + (size_t)e * M * K, blockIdx.y * S::BM, 0, M, K, we, we, N,
                blockIdx.x * S::BN, oe, oe, oe, smem);
}

// One block = one (row tile, expert) work item x one tile of BN / OPS
// output columns: OPS = 1 the ragged GEMM (out0), OPS = 2 the fused
// gate-up-SiLU (out0, out1, out2 = h, a_g, a_u from w0 = Wg, w1 = Wu).
template <typename S, int OPS, typename TX>
__global__ void __launch_bounds__(S::THREADS, S::MINB)
ragged_tc_kernel(const TX* __restrict__ x, const bf16* __restrict__ w0,
                 const bf16* __restrict__ w1, const int* __restrict__ offsets,
                 const int* __restrict__ tile_m, const int* __restrict__ grp,
                 const int* __restrict__ valid, float* __restrict__ out0,
                 float* __restrict__ out1, float* __restrict__ out2, int T, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.y;
  if (!valid[item]) return;  // surplus item: uniform per block, before any barrier
  const int e = grp[item];
  const size_t we = (size_t)e * K * N;
  tc_tile<S, OPS>(x, tile_m[item] * S::BM, offsets[e], min(offsets[e + 1], T), K, w0 + we,
                  w1 + we, N, blockIdx.x * (S::BN / OPS), out0, out1, out2, smem);
}

// ---------------------------------------------------------------------------
// Ragged dgrad
// ---------------------------------------------------------------------------

// One dgrad operand's shared memory: a ring of BR x C slabs of T (bf16 rows
// padded by 16 bytes for ldmatrix; fp32 rows unpadded, read once by the
// split) and, for fp32, three bf16 planes [3][BR][C + 8] of its pieces.
template <typename T, int BR, int C, int STAGES> struct DwOperand {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int PIECES = SPLIT ? 3 : 1;
  static constexpr int LD = C + 8;              // row stride of what ldmatrix reads
  static constexpr int RLD = SPLIT ? C : LD;    // row stride of the ring
  static constexpr int RING = STAGES * BR * RLD * (int)sizeof(T);
  static constexpr int PLANES = SPLIT ? 3 * BR * LD * 2 : 0;
  // 16-byte copy slots of one slab, per thread.
  static constexpr int EPC = 16 / sizeof(T), CC = C / EPC;

  // The bf16 fragments' base: the planes of an fp32 slab, else the slab.
  static __device__ __forceinline__ const bf16* frags(const T* slab, const bf16* planes) {
    if constexpr (SPLIT) return planes;
    else return reinterpret_cast<const bf16*>(slab);
  }

  // Splits the landed fp32 slab into its three bf16 planes.
  template <int THREADS>
  static __device__ __forceinline__ void split(const T* slab, bf16* planes, int tid) {
    if constexpr (SPLIT) {
      constexpr int Q = C / 4, N4 = BR * Q;
      static_assert(N4 % THREADS == 0, "whole float4 a thread");
#pragma unroll
      for (int j = 0; j < N4 / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / Q, c = (i % Q) * 4;
        const float4 v = *reinterpret_cast<const float4*>(slab + r * RLD + c);
        uint32_t h0, m0, l0, h1, m1, l1;
        split_bf16x3(make_float2(v.x, v.y), h0, m0, l0);
        split_bf16x3(make_float2(v.z, v.w), h1, m1, l1);
        bf16* p = planes + r * LD + c;
        *reinterpret_cast<uint2*>(p) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(p + BR * LD) = make_uint2(m0, m1);
        *reinterpret_cast<uint2*>(p + 2 * BR * LD) = make_uint2(l0, l1);
      }
    }
  }
};

template <typename S, typename TX, typename TG> constexpr int dw_smem_bytes() {
  using A = DwOperand<TX, S::BK, S::BM, S::STAGES>;
  using B = DwOperand<TG, S::BK, S::BN, S::STAGES>;
  return A::RING + B::RING + A::PLANES + B::PLANES;
}

// dW[e][k][n] = sum over rows r of expert e of x[r][k] * g[r][n], for the
// BM x BN tile at (blockIdx.y * BM, blockIdx.x * BN) of expert blockIdx.z.
template <typename S, typename TX, typename TG>
__global__ void __launch_bounds__(S::THREADS, S::MINB)
ragged_dw_tc_kernel(const TX* __restrict__ x, const TG* __restrict__ gm,
                    const int* __restrict__ offsets, float* __restrict__ out, int T, int K,
                    int N) {
  constexpr int BM = S::BM, BN = S::BN, BR = S::BK, STAGES = S::STAGES, THREADS = S::THREADS;
  constexpr int WM = S::WM, WN = S::WN, MI = WM / 16, NI = WN / 8, WARPS_N = BN / WN;
  static_assert(NI % 2 == 0, "n tiles go in pairs (one ldmatrix.x4.trans)");
  using A = DwOperand<TX, BR, BM, STAGES>;
  using B = DwOperand<TG, BR, BN, STAGES>;
  constexpr int PA = A::PIECES, PB = B::PIECES, PMAX = PA > PB ? PA : PB;
  constexpr int NA = BR * A::CC / THREADS, NB = BR * B::CC / THREADS;
  static_assert(NA * THREADS == BR * A::CC && NB * THREADS == BR * B::CC,
                "whole chunks a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  TX* ra = reinterpret_cast<TX*>(smem);                                  // [STAGES][BR][A::RLD]
  TG* rb = reinterpret_cast<TG*>(smem + A::RING);                        // [STAGES][BR][B::RLD]
  bf16* pa = reinterpret_cast<bf16*>(smem + A::RING + B::RING);          // [3][BR][A::LD]
  bf16* pb = reinterpret_cast<bf16*>(smem + A::RING + B::RING + A::PLANES);  // [3][BR][B::LD]

  const int e = blockIdx.z, k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lo = min(offsets[e], T), hi = min(offsets[e + 1], T);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / WARPS_N) * WM, wc = (warp % WARPS_N) * WN;

  // Copy slots: slab row and column fixed, the slab's first row moves.
  const TX* a_src[NA];
  const TG* b_src[NB];
  int a_dst[NA], a_r[NA], b_dst[NB], b_r[NB];
  bool a_ok[NA], b_ok[NB];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int i = tid + j * THREADS, r = i / A::CC, c = (i % A::CC) * A::EPC;
    a_ok[j] = k0 + c < K;
    a_src[j] = x + (size_t)r * K + (a_ok[j] ? k0 + c : 0);
    a_dst[j] = r * A::RLD + c;
    a_r[j] = r;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int i = tid + j * THREADS, r = i / B::CC, c = (i % B::CC) * B::EPC;
    b_ok[j] = n0 + c < N;
    b_src[j] = gm + (size_t)r * N + (b_ok[j] ? n0 + c : 0);
    b_dst[j] = r * B::RLD + c;
    b_r[j] = r;
  }
  // Rows at or past hi (the next expert's, the tail's) are zero-filled in
  // both operands and never read.
  auto load_stage = [&](int st, int r0) {
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const bool ok = a_ok[j] && r0 + a_r[j] < hi;
      cp_async16(ra + st * BR * A::RLD + a_dst[j], ok ? a_src[j] + (size_t)r0 * K : x, ok);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const bool ok = b_ok[j] && r0 + b_r[j] < hi;
      cp_async16(rb + st * BR * B::RLD + b_dst[j], ok ? b_src[j] + (size_t)r0 * N : gm, ok);
    }
  };

  constexpr int PS = S::PK / BR;  // slabs a part spans
  static_assert(PS * BR == S::PK, "PK a multiple of BR");
  float acc[MI][NI][4], part[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  const int KT = hi > lo ? (hi - lo + BR - 1) / BR : 0;  // uniform per block
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, lo + s * BR);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // slab kt has landed
    __syncthreads();              // ... for all threads; slab kt-1 and the planes are consumed
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, lo + (kt + STAGES - 1) * BR);
    cp_async_commit();
    const TX* sa = ra + (kt % STAGES) * BR * A::RLD;
    const TG* sb = rb + (kt % STAGES) * BR * B::RLD;
    if constexpr (A::SPLIT || B::SPLIT) {
      A::template split<THREADS>(sa, pa, tid);
      B::template split<THREADS>(sb, pb, tid);
      __syncthreads();
    }
    const bf16* fa = A::frags(sa, pa);
    const bf16* fb = B::frags(sb, pb);
    if (kt % PS == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mi][ni][c] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // A = x^T: matrix j of the x4 is (rows kk + 8 (j / 2) .., k + 8 (j % 2) ..),
      // transposed into the a0..a3 layout of mma.sync.
      uint32_t a[MI][PA][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int p = 0; p < PA; ++p)
          ldmatrix_x4_trans(a[mi][p], fa + p * BR * A::LD +
                                          (kk + (lane & 7) + ((lane >> 4) << 3)) * A::LD + wr +
                                          mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[PB][4];
#pragma unroll
        for (int p = 0; p < PB; ++p)
          ldmatrix_x4_trans(b[p], fb + p * BR * B::LD + (kk + (lane & 15)) * B::LD + wc +
                                      np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int i = 0; i < PA; ++i)
#pragma unroll
            for (int j = 0; j < PB; ++j)
              if (i + j < PMAX) {  // fp32 x fp32: the six products above 2^-24
                mma_bf16(part[mi][2 * np], a[mi][i], b[j][0], b[j][1]);
                mma_bf16(part[mi][2 * np + 1], a[mi][i], b[j][2], b[j][3]);
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
    const int k = k0 + wr + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = n0 + wc + ni * 8 + 2 * t;  // N even: n < N covers n + 1
      if (n >= N) continue;
      float* o = out + ((size_t)e * K + k) * N + n;
      if (k < K) *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (k + 8 < K)
        *reinterpret_cast<float2*>(o + 8 * (size_t)N) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename S, typename TX>
int launch_grouped(const void* x, const void* w, void* out, int E, int M, int K, int N,
                   void* stream) {
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

template <typename S, int OPS, typename TX>
int launch_ragged(const void* x, const void* w0, const void* w1, const int* offsets,
                  const int* tile_m, const int* grp, const int* valid, void* out0, void* out1,
                  void* out2, int T, int K, int N, int G, void* stream) {
  constexpr int SMEM = smem_bytes<S, TX>(), BNO = S::BN / OPS;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_tc_kernel<S, OPS, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + BNO - 1) / BNO, G);
  ragged_tc_kernel<S, OPS, TX><<<grid, S::THREADS, SMEM, (cudaStream_t)stream>>>(
      static_cast<const TX*>(x), static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
      offsets, tile_m, grp, valid, static_cast<float*>(out0), static_cast<float*>(out1),
      static_cast<float*>(out2), T, K, N);
  return (int)cudaGetLastError();
}

template <typename TX, typename TG>
int launch_dw(const void* x, const void* g, const int* offsets, void* out, int T, int K, int N,
              int E, void* stream) {
  using S = DwTile;
  constexpr int SMEM = dw_smem_bytes<S, TX, TG>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_dw_tc_kernel<S, TX, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + S::BN - 1) / S::BN, (K + S::BM - 1) / S::BM, E);
  ragged_dw_tc_kernel<S, TX, TG><<<grid, S::THREADS, SMEM, (cudaStream_t)stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g), offsets, static_cast<float*>(out),
      T, K, N);
  return (int)cudaGetLastError();
}

// 16-byte rows for cp.async: a multiple of 8 (bf16) or 4 (fp32) elements.
bool rows16(int dt, int n) {
  return n > 0 && ((dt == kBF16 && n % 8 == 0) || (dt == kF32 && n % 4 == 0));
}

// Tile codes, as TILES in kernels/moe_gemm/ops.py lists them.
enum Tile { kTile128 = 0, kTile64 = 1, kTile64Split = 2, kSkinny = 3 };

// f(Shape, const TX*) for a tile code built for x's dtype code; an error
// for any other pair.
template <typename F> int with_tile(int xdt, int tile, F&& f) {
  if (xdt == kF32) {
    if (tile == kTile64Split) return f(Tile64Split{}, static_cast<const float*>(nullptr));
    if (tile == kSkinny) return f(Skinny{}, static_cast<const float*>(nullptr));
  } else if (xdt == kBF16) {
    if (tile == kTile128) return f(Tile128{}, static_cast<const bf16*>(nullptr));
    if (tile == kTile64) return f(Tile64{}, static_cast<const bf16*>(nullptr));
    if (tile == kSkinny) return f(Skinny{}, static_cast<const bf16*>(nullptr));
  }
  return (int)cudaErrorInvalidValue;  // a tile not built for this x dtype
}

}  // namespace

extern "C" int grouped_matmul_f32_tc(const void* x, int xdt, const void* w, void* out, int E,
                                     int M, int K, int N, int tile, void* stream) {
  if (E <= 0 || M <= 0 || !rows16(xdt, K) || !rows16(kBF16, N))
    return (int)cudaErrorInvalidValue;
  return with_tile(xdt, tile, [&](auto s, auto* xp) {
    return launch_grouped<decltype(s), elem_t<decltype(xp)>>(x, w, out, E, M, K, N, stream);
  });
}

extern "C" int ragged_matmul_f32_tc(const void* x, int xdt, const void* w, const int* offsets,
                                    const int* tile_m, const int* grp, const int* valid,
                                    void* out, int T, int K, int N, int G, int tile,
                                    void* stream) {
  if (T <= 0 || G <= 0 || !rows16(xdt, K) || !rows16(kBF16, N))
    return (int)cudaErrorInvalidValue;
  return with_tile(xdt, tile, [&](auto s, auto* xp) {
    // ragged_tile never picks Tile128 (a tile straddling two experts is one
    // work item each, so taller tiles add straddled rows): not built here.
    if constexpr (std::is_same<decltype(s), Tile128>::value) return (int)cudaErrorInvalidValue;
    else
      return launch_ragged<decltype(s), 1, elem_t<decltype(xp)>>(
          x, w, w, offsets, tile_m, grp, valid, out, out, out, T, K, N, G, stream);
  });
}

// The fused gate-up-SiLU on the ragged tiles (ragged_tile's codes, as
// ragged_matmul_f32_tc; Tile64 runs as Tile64Pair, of the same height): h,
// a_g, a_u (T, F) fp32, F a multiple of 8.
extern "C" int ragged_gate_up_silu_f32_tc(const void* x, int xdt, const void* w_gate,
                                          const void* w_up, const int* offsets,
                                          const int* tile_m, const int* grp, const int* valid,
                                          void* h, void* a_g, void* a_u, int T, int K, int F,
                                          int G, int tile, void* stream) {
  if (T <= 0 || G <= 0 || !rows16(xdt, K) || !rows16(kBF16, F))
    return (int)cudaErrorInvalidValue;
  return with_tile(xdt, tile, [&](auto s, auto* xp) {
    using S = decltype(s);
    if constexpr (std::is_same<S, Tile128>::value) return (int)cudaErrorInvalidValue;
    else
      return launch_ragged<std::conditional_t<std::is_same<S, Tile64>::value, Tile64Pair, S>, 2,
                           elem_t<decltype(xp)>>(x, w_gate, w_up, offsets, tile_m, grp, valid,
                                                 h, a_g, a_u, T, K, F, G, stream);
  });
}

// Every pair of fp32 and bf16 operands; x and g rows 16-byte multiples.
extern "C" int ragged_dw_f32_tc(const void* x, int xdt, const void* g, int gdt,
                                const int* offsets, void* out, int T, int K, int N, int E,
                                void* stream) {
  if (E <= 0 || !rows16(xdt, K) || !rows16(gdt, N)) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaErrorInvalidValue;
  with_dtype(xdt, [&](auto* xp) {
    with_dtype(gdt, [&](auto* gp) {
      rc = launch_dw<elem_t<decltype(xp)>, elem_t<decltype(gp)>>(x, g, offsets, out, T, K, N, E,
                                                               stream);
    });
  });
  return rc;
}
