// Mamba2 SSD intra-chunk term on Hopper's tensor cores (sm_90a), bf16 x,
// dA, B, C and output: bf16 mma.sync with fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py:51
// ssd_intra_chunk (body _ssd_kernel :27) for bf16 inputs, as on the SSM
// serving path; fp32 inputs keep ssd_intra_chunk_kernel in ssd.cu (fp32 FMA,
// the fp32 parity runs).  The wrapper in kernels/ssd/ops.py chooses by
// dtype, never because a launch failed.  For every (g = batch*chunk, head):
//
//     cs = cumsum(dA)                                   (over the chunk)
//     Y[l] = sum_{s <= l} exp(cs[l] - cs[s]) * (C[l].B[s]) * x[s]
//
// computed in fp32 from the inputs' values and rounded once to bf16.
//
// What bounds it on an H100: bytes.  At mamba2-370m's 4 x 2048 prefill (g =
// 32 chunks of 256, 32 heads, p = 64, n = 128, one B/C group) x, dA and y
// are ~33 MB and B, C ~4 MB (read once per chunk through their stride-0
// head views): 0.021 ms at 3.35 TB/s.  C.B^T is the same for all heads of a
// group (0.27 GFLOP once per chunk); the decayed scores . x are 4.3 GFLOP,
// 12.9 as the three bf16 pieces below, 0.013 ms of bf16 mma.
//
// Design: one block per (64-row query tile, group of HB = 1 or 2 heads, g),
// the longest causal walks first, 4 warps per head (128 * HB threads); warp
// w owns query rows 16 (w % 4) .. and head w / 4 of the group.  The block
//   1. sums cs of each of its heads in fp64 (warp j: head j, a warp scan),
//      each prefix rounded once to fp32, as ssd.cu and ssd/ref.py do;
//   2. walks the key tiles at or below its diagonal (tiles above it give
//      exact zeros for finite inputs and are skipped), C_q and each key
//      tile's B and x (one tile per head) arriving global -> shared by
//      16-byte cp.async, double-buffered, rows padded by 16 bytes for
//      conflict-free ldmatrix, rows past the chunk and columns past p or n
//      zero-filled (src-size 0);
//   3. per key tile: S = C_q . B_t^T by bf16 mma (products exact in fp32,
//      runs of 64 of n summed apart and joined by fp32 adds: the tensor
//      cores' accumulator truncates), ONCE for all HB heads: with B and C
//      head-broadcast (head stride 0, one group) S does not depend on the
//      head; each warp computes 16 rows x 64 / HB keys of it into a shared
//      fp32 tile.  HB > 1 is refused for per-head B or C;
//   4. per warp, for its head: reads its 16 rows of S back in the mma
//      accumulator layout, masks pairs above the diagonal and rows past the
//      chunk BEFORE any multiply (the decay is exp of the DIFFERENCE
//      cs[l] - cs[s], never exp(cs[l]) * exp(-cs[s]); under a strong decay
//      the excluded pairs' exponent is huge and would give inf * 0), forms
//      the fp32 decayed scores, splits them into three bf16 pieces (hi +
//      mid + lo, exactly the fp32 value, so the result differs from the
//      plain version only by the order of its fp32 sums; two pieces, as
//      flash takes P, would add P's rounding, 2^-17 of each score, to
//      outputs held at an absolute 3e-5) and reuses them as the A operand
//      of Y += P . x_t against x_t by ldmatrix.trans;
//   5. rounds Y once to bf16 and stores the rows inside the chunk.
// The heads per block come from the wrapper (ssd.ops.heads_per_block: 2
// where the grid stays large enough and p <= 64, else 1) and must divide H.
// Timed on the card at mamba2-370m's 4 x 2048 prefill: two heads a block
// 3 % faster than four, though four share S twice as widely (why is not
// measured), and 30 % faster than one; at p = 128 two heads a block
// spilled past the 128 registers of two blocks an SM.

#include "common.cuh"
#include "mma.cuh"

#include <cstdint>

namespace {

constexpr int BT = 64;      // query rows per block = keys per tile
constexpr int MAX_CL = 256;
constexpr int SLD = BT + 8;  // fp32 row stride of the score tile
constexpr int PK = 64;       // n summed apart on the tensor cores
constexpr int SMEM_MAX = 232448;

struct Str3 {
  long long g, l, h;
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of one block, at most ~155 KB (HB = 2, p = 64, n = 256):
// cs [HB][MAX_CL] fp32, S [BT][SLD] fp32, C_q [BT][n16 + 8], B [2][BT][n16 +
// 8] and x [2][HB][BT][PT + 8] bf16.
inline int smem_bytes(int hb, int pt, int n) {
  const int cld = round16(n) + 8;
  return 4 * (hb * MAX_CL + BT * SLD) + 2 * (3 * BT * cld + 2 * hb * BT * (pt + 8));
}

// rows [row0, row0 + BT) x cols [0, cols16) of a (rows, ld) bf16 tile from
// base (row stride `stride` elements); rows at or past nrows and columns at
// or past ncols are zero-filled.
template <int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* base, long long stride,
                                          int row0, int nrows, int cols16, int ncols) {
  const int cpr = cols16 / 8;
  for (int i = threadIdx.x; i < BT * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8, row = row0 + r;
    const bool ok = row < nrows && c < ncols;
    cp_async16(dst + r * ld + c, ok ? base + row * stride + c : base, ok);
  }
}

template <int HB, int PT>
__global__ void __launch_bounds__(128 * HB, 2)
ssd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dA,
              const bf16* __restrict__ B, const bf16* __restrict__ C, bf16* __restrict__ out,
              int CL, int H, int P, int N, Str3 xs, Str3 bs, Str3 cs_, Str3 das) {
  constexpr int THREADS = 128 * HB, XLD = PT + 8, KN = BT / HB, SNT = KN / 8, DT = PT / 8;
  static_assert(SNT % 2 == 0 && DT % 2 == 0, "n tiles go in pairs (one ldmatrix.x4)");
  const int NK = round16(N), CLD = NK + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);  // [HB][MAX_CL]
  float* ss = cs + HB * MAX_CL;                // [BT][SLD]
  bf16* cq = reinterpret_cast<bf16*>(ss + BT * SLD);  // [BT][CLD]
  bf16* bk = cq + BT * CLD;                    // [2][BT][CLD]
  bf16* xk = bk + 2 * BT * CLD;                // [2][HB][BT][XLD]

  const int n_qt = (CL + BT - 1) / BT;
  const int qt = n_qt - 1 - blockIdx.x;  // the longest walks start first
  const int h0 = blockIdx.y * HB, g = blockIdx.z, q0 = qt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int rw = (warp % 4) * 16, hw = warp / 4;

  // 1. cs of head h0 + j by warp j: each lane sums its slice in fp64, a warp
  //    scan adds the lanes before it, every prefix is rounded once.
  if (warp < HB) {
    constexpr int PER = MAX_CL / 32;
    const bf16* dap = dA + g * das.g + (h0 + warp) * das.h;
    double v[PER];
    double run = 0.0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int l = lane * PER + i;
      run += l < CL ? (double)__bfloat162float(dap[(long long)l * das.l]) : 0.0;
      v[i] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const double up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const double before = incl - run;
#pragma unroll
    for (int i = 0; i < PER; ++i) cs[warp * MAX_CL + lane * PER + i] = (float)(before + v[i]);
  }

  // 2. C_q once; B and the HB heads' x per key tile, double-buffered.
  const bf16* bp = B + g * bs.g + h0 * bs.h;
  const bf16* xp = x + g * xs.g + h0 * xs.h;
  load_tile<THREADS>(cq, CLD, C + g * cs_.g + h0 * cs_.h, cs_.l, q0, CL, NK, N);
  auto load_kv = [&](int kt) {
    const int st = kt & 1;
    load_tile<THREADS>(bk + st * BT * CLD, CLD, bp, bs.l, kt * BT, CL, NK, N);
#pragma unroll
    for (int j = 0; j < HB; ++j)
      load_tile<THREADS>(xk + (st * HB + j) * BT * XLD, XLD, xp + j * xs.h, xs.l, kt * BT, CL,
                         PT, P);
  };
  load_kv(0);
  cp_async_commit();

  float y[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) y[d][c] = 0.f;
  const int l0 = q0 + rw + gq, l1 = l0 + 8;
  const float* csh = cs + hw * MAX_CL;

  for (int kt = 0; kt <= qt; ++kt) {
    if (kt < qt) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // C_q and tile kt have landed
    __syncthreads();     // ... for all threads (cs too)
    const bf16* bt = bk + (kt & 1) * BT * CLD;

    // 3. S for rows rw .. rw + 15, keys hw * KN .. + KN of the tile, each
    //    run of PK of n joined into the shared tile by fp32 adds (each
    //    thread adds to its own elements: no barrier between runs).
    float part[SNT][4];
    for (int k0 = 0; k0 < NK; k0 += PK) {
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[nt][c] = 0.f;
      const int k1 = min(NK, k0 + PK);
      for (int kk = k0; kk < k1; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, cq + (rw + (lane & 15)) * CLD + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < SNT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, bt + (hw * KN + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * CLD + kk +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(part[2 * np], a, b[0], b[1]);
          mma_bf16(part[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
        float2* o0 = reinterpret_cast<float2*>(ss + (rw + gq) * SLD + hw * KN + nt * 8 + 2 * t);
        float2* o1 = o0 + 4 * SLD;  // row + 8
        float2 v0 = make_float2(part[nt][0], part[nt][1]);
        float2 v1 = make_float2(part[nt][2], part[nt][3]);
        if (k0 > 0) {
          v0.x += o0->x, v0.y += o0->y;
          v1.x += o1->x, v1.y += o1->y;
        }
        *o0 = v0;
        *o1 = v1;
      }
    }
    __syncthreads();

    // 4. Y += P . x_t for head h0 + hw, 16 keys a step.
    const float cl0 = csh[l0], cl1 = csh[l1];
    const bf16* xt = xk + ((kt & 1) * HB + hw) * BT * XLD;
    const int k0 = kt * BT;
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      float p[2][4];  // n tiles 2 kk and 2 kk + 1 of P, accumulator layout
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (2 * kk + j) * 8 + 2 * t, s0 = k0 + col;
        const float2 r0 = *reinterpret_cast<const float2*>(ss + (rw + gq) * SLD + col);
        const float2 r1 = *reinterpret_cast<const float2*>(ss + (rw + gq + 8) * SLD + col);
        const float c0 = csh[s0], c1 = csh[s0 + 1];
        const bool v0 = l0 < CL, v1 = l1 < CL;
        // decay 0 outside the causal chunk, chosen before the multiply
        p[j][0] = r0.x * (v0 && s0 <= l0 ? expf(cl0 - c0) : 0.f);
        p[j][1] = r0.y * (v0 && s0 + 1 <= l0 ? expf(cl0 - c1) : 0.f);
        p[j][2] = r1.x * (v1 && s0 <= l1 ? expf(cl1 - c0) : 0.f);
        p[j][3] = r1.y * (v1 && s0 + 1 <= l1 ? expf(cl1 - c1) : 0.f);
      }
      // A layout of P . x: a0 (row g, k 2t..), a1 (row g + 8), a2, a3 the
      // same 8 keys further on, i.e. tiles 2 kk and 2 kk + 1.
      uint32_t ph[4], pm[4], pl[4];
      split_bf16x3(make_float2(p[0][0], p[0][1]), ph[0], pm[0], pl[0]);
      split_bf16x3(make_float2(p[0][2], p[0][3]), ph[1], pm[1], pl[1]);
      split_bf16x3(make_float2(p[1][0], p[1][1]), ph[2], pm[2], pl[2]);
      split_bf16x3(make_float2(p[1][2], p[1][3]), ph[3], pm[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, xt + (kk * 16 + (lane & 15)) * XLD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(y[2 * dp], pl, vf[0], vf[1]);  // smallest pieces first
        mma_bf16(y[2 * dp + 1], pl, vf[2], vf[3]);
        mma_bf16(y[2 * dp], pm, vf[0], vf[1]);
        mma_bf16(y[2 * dp + 1], pm, vf[2], vf[3]);
        mma_bf16(y[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(y[2 * dp + 1], ph, vf[2], vf[3]);
      }
    }
    __syncthreads();  // S and this stage are consumed before they are refilled
  }
  cp_async_wait<0>();

  // 5. Rows inside the chunk, columns inside p (P % 8 == 0: d < P covers d + 1).
  const int h = h0 + hw;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (col >= P) continue;
    if (l0 < CL)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)g * CL + l0) * H + h) * P + col) =
          __floats2bfloat162_rn(y[d][0], y[d][1]);
    if (l1 < CL)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)g * CL + l1) * H + h) * P + col) =
          __floats2bfloat162_rn(y[d][2], y[d][3]);
  }
}

template <int HB, int PT>
int launch(const void* x, const void* dA, const void* B, const void* C, void* out, int G, int CL,
           int H, int P, int N, Str3 xs, Str3 bs, Str3 cs, Str3 das, cudaStream_t stream) {
  const int smem = smem_bytes(HB, PT, N);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // per instantiation: raise the cap once per size
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_kernel<HB, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid((CL + BT - 1) / BT, H / HB, G);
  ssd_tc_kernel<HB, PT><<<grid, 128 * HB, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dA), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<bf16*>(out), CL, H, P, N, xs, bs, cs, das);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
bool rows8(const Str3& s) { return s.g % 8 == 0 && s.l % 8 == 0 && s.h % 8 == 0; }

}  // namespace

// x (G, CL, H, P), dA (G, CL, H), B and C (G, CL, H, N), all bf16: strides of
// their first three dims in elements; the last dim contiguous, P and N
// multiples of 8, x, B and C rows 16-byte aligned (cp.async).  out
// contiguous (G, CL, H, P) bf16.  HB heads per block (1 or 2, dividing
// H); HB = 2 needs head-broadcast B and C (head stride 0) and P <= 64.
extern "C" int ssd_intra_chunk_tc(const void* x, const void* dA, const void* B, const void* C,
                                  void* out, int G, int CL, int H, int P, int N, int HB,
                                  long long x_sg, long long x_sl, long long x_sh, long long b_sg,
                                  long long b_sl, long long b_sh, long long c_sg, long long c_sl,
                                  long long c_sh, long long d_sg, long long d_sl, long long d_sh,
                                  void* stream) {
  const Str3 xs{x_sg, x_sl, x_sh}, bs{b_sg, b_sl, b_sh}, cs{c_sg, c_sl, c_sh},
      das{d_sg, d_sl, d_sh};
  if (G <= 0 || CL <= 0 || CL > MAX_CL || H <= 0 || P <= 0 || P > 128 || P % 8 || N <= 0 ||
      N > 256 || N % 8 || (HB != 1 && HB != 2) || H % HB ||
      (HB > 1 && (b_sh != 0 || c_sh != 0 || P > 64)) || !rows8(xs) || !rows8(bs) || !rows8(cs) ||
      !aligned16(x) || !aligned16(B) || !aligned16(C))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto hb, auto pt) {
    return launch<decltype(hb)::value, decltype(pt)::value>(x, dA, B, C, out, G, CL, H, P, N, xs,
                                                            bs, cs, das, (cudaStream_t)stream);
  };
  auto by_p = [&](auto hb) {
    if (P <= 16) return go(hb, Int<16>{});
    if (P <= 32) return go(hb, Int<32>{});
    if (P <= 64) return go(hb, Int<64>{});
    // p = 128 with several heads a block spills past 128 registers: not built
    if constexpr (decltype(hb)::value == 1) return go(hb, Int<128>{});
    else return (int)cudaErrorInvalidValue;
  };
  return HB == 1 ? by_p(Int<1>{}) : by_p(Int<2>{});
}
