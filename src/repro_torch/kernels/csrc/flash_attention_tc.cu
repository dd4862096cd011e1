// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 q/k/v:
// FA2-style, bf16 mma.sync with the online softmax in fp32 registers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:103 flash_attention (body _fa_kernel :30) for bf16
// inputs, as on the serving path; fp32 inputs keep fa_fwd_kernel in
// flash_attention.cu (fp32 FMA: the fp32 paged-decode parity probe is held
// to 1e-5, which TF32 or bf16 products would break).  The wrapper chooses
// by dtype, never because a launch failed.  Same function as there: causal
// GQA (kv head h // groups, no K/V repeat), sliding window, logit softcap,
// the TPU masking rule (masked scores are -1e30 and still enter
// exp(s - m); keys past the end are -inf) and the l == 0 guard; key tiles
// wholly above the causal diagonal or left of the window are skipped.  A
// query offset (the reference attention's q_offset) places query row i at
// position q_offset + i against keys 0 .. SKV - 1: the masks and the tile
// skip read that position, so q_offset = 0 is the kernel it was.
//
// What bounds it on an H100: at granite-moe-3b's prefill (b = 1, s = 512,
// 24 query heads over 8 KV heads, d = 64) one call is 0.81 GFLOP causal
// (0.8 us at the bf16 tensor rate) against 4.7 MB of q, k, v and out (1.4 us
// at 3.35 TB/s): both bounds are microseconds, so the kernel is bound by
// latency, i.e. by how few dependent steps the longest block takes.
//
// Design: one 128-thread block (4 warps) per (64-row query tile, query
// head, batch), the heaviest causal tiles first; each warp owns 16 query
// rows.  GQA groups are not packed into one block: a KV head's K/V tile is
// re-read by its query heads from L2 (64 KB a head at s = 512), and the
// simpler masks keep one position per row.  Q is staged once and held in
// registers as mma A fragments (ldmatrix).  K/V tiles of 64 keys travel
// global -> shared by 16-byte cp.async through a 3-stage ring (2 stages at
// d = 128, where K, V and Q take 87 KB of dynamic shared memory), rows
// padded by 16 bytes for conflict-free ldmatrix.  S = Q.K^T by mma
// m16n8k16 (K via ldmatrix); scale, softcap and masks on the fp32
// accumulator fragments; row max and sum across the quad of lanes that
// share a row (shuffles); P is split in registers into two bf16 pieces
// (hi + lo, 16 significant bits), the S accumulator layout reused as the A
// operand of P.V, V via ldmatrix.trans, two mma per step.  P rounded to one
// bf16, as FlashAttention-2 does, put single outputs past the fp32 plain
// version's bound (max |err| 7.8e-3 at s = 512 against atol 2e-3 +
// rtol 1e-2); the second piece doubles the P.V mma (half again the
// kernel's) and keeps P's rounding below the output's own bf16 rounding.
// Rows of q, k and v are read through their strides (the model's fused-QKV
// views need no copy) and must be 16-byte aligned (the wrapper checks);
// rows past the end are zero-filled on load and never stored.
//
// d = 256 (gemma2-9b) is its own layout (Layout<256>): its fp32 output
// accumulator alone is 128 registers a thread (o[32][4]), Q held as A
// fragments would add 64 and S of a 64-key tile 32, past what 255
// registers leave for addresses and the P pieces.  So Q is not held: each
// k step of S = Q.K^T reads its A fragment from the Q tile, which stays
// resident in shared memory (one ldmatrix beside the two of K); and a key
// tile is 32 keys (S 16 registers).  Three stages of 64-key tiles would
// take 236,544 B of shared memory, past the 232,448 a block may have; two
// stages of 32-key tiles take 101,376 B, so two blocks fit an SM.  There
// the card's bound is its tensor rate: at gemma2's prefill (b = 1, s =
// 4096, 16 query heads over 8 KV heads) one causal call is 137.5 GFLOP
// (0.139 ms at 989 TFLOP/s) against 100.7 MB of q, k, v and out (0.030 ms).

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block (16 per warp)
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;
};

// Per head dim: keys per shared-memory tile, cp.async ring depth, and
// whether Q's A fragments are held in registers (else re-read each k step).
template <int D> struct Layout {
  static constexpr int BKV = 64, STAGES = D == 128 ? 2 : 3;
  static constexpr bool Q_REGS = true;
};
template <> struct Layout<256> {
  static constexpr int BKV = 32, STAGES = 2;
  static constexpr bool Q_REGS = false;
};
template <int D> constexpr int smem_bytes() {
  return (BQ + 2 * Layout<D>::STAGES * Layout<D>::BKV) * (D + 8) * 2;
}
static_assert(smem_bytes<256>() <= 232448 / 2, "two d = 256 blocks must fit an SM");

// rows [row0, row0 + ROWS) of one head into a [ROWS][D + 8] tile; rows at
// or past nvalid are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long stride,
                                          int row0, int nvalid) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, row = row0 + r;
    const bool ok = row < nvalid;
    cp_async16(dst + r * (D + 8) + c, ok ? base + row * stride + c : base, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int HQ, int HKV, int SQ,
             int SKV, Strides qs, Strides ks, Strides vs, int causal, int window,
             float softcap, float scale, int q_offset) {
  constexpr int BKV = Layout<D>::BKV, STAGES = Layout<D>::STAGES;
  constexpr bool Q_REGS = Layout<D>::Q_REGS;
  constexpr int LD = D + 8, KD = D / 16, NT = BKV / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* k_s = q_s + BQ * LD;                  // [STAGES][BKV][LD]
  bf16* v_s = k_s + STAGES * BKV * LD;        // [STAGES][BKV][LD]

  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // Block-level relevance: keys <= the tile's last row (causal), keys
  // > its first row - window (sliding window), rows at their global
  // positions q_offset + i.
  const int q_pos0 = q_offset + q_start;
  const int kv_end = causal ? min(SKV, q_pos0 + BQ) : SKV;
  const int kv_begin = window > 0 ? max(0, q_pos0 - (window - 1)) / BKV * BKV : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  auto load_kv = [&](int j) {
    const int st = j % STAGES, k0 = kv_begin + j * BKV;
    load_rows<D, BKV>(k_s + st * BKV * LD, kb, ks.s, k0, SKV);
    load_rows<D, BKV>(v_s + st * BKV * LD, vb, vs.s, k0, SKV);
  };
  load_rows<D, BQ>(q_s, qb, qs.s, q_start, SQ);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // the Q group has landed
  __syncthreads();
  // This lane's ldmatrix row of the warp's Q rows, and the A fragments
  // (held only where Layout says so).
  const bf16* q_row = q_s + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[Q_REGS ? KD : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_row + kk * 16);
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int qi0 = q_start + warp * 16 + g, qi1 = qi0 + 8;
  const int qp0 = q_offset + qi0, qp1 = qp0 + 8;  // their global positions

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed
    __syncthreads();              // ... for all threads; tile j-1 is consumed
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
    cp_async_commit();
    const bf16* kt = k_s + (j % STAGES) * BKV * LD;
    const bf16* vt = v_s + (j % STAGES) * BKV * LD;
    const int k0 = kv_begin + j * BKV;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int c = 0; c < 4; ++c) qa[c] = qf[kk][c];
      } else {
        ldmatrix_x4(qa, q_row + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + nt * 8 + 2 * t + (c & 1), qi = c < 2 ? qp0 : qp1;
        float sc = s[nt][c] * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        bool vis = true;
        if (causal) vis = vis && key <= qi;
        if (window > 0) vis = vis && key > qi - window;
        sc = vis ? sc : NEG_INF;
        sc = key < SKV ? sc : -INFINITY;  // past the end: not a key at all
        s[nt][c] = sc;
        if (c < 2) mx0 = fmaxf(mx0, sc);
        else mx1 = fmaxf(mx1, sc);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m0);  // exp(-inf) = 0 past the end
      s[nt][1] = __expf(s[nt][1] - m0);
      s[nt][2] = __expf(s[nt][2] - m1);
      s[nt][3] = __expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      // P as two bf16 pieces in the A layout of P.V (the S accumulator's
      // C layout: tiles 2kk and 2kk+1 are the k halves of this k step)
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
        mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  bf16* ob = out + (long long)b * SQ * HQ * D + (long long)h * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (qi0 < SQ)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qi0 * HQ * D + d) =
          __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    if (qi1 < SQ)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qi1 * HQ * D + d) =
          __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                  int dt, int B, int HQ, int HKV, int SQ, int SKV, int D,
                                  long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, int causal,
                                  int window, float softcap, float scale, int q_offset,
                                  void* stream) {
  if (dt != kBF16 || HKV <= 0 || HQ % HKV != 0 || SQ <= 0 || SKV <= 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const dim3 grid((SQ + BQ - 1) / BQ, HQ, B);
  int rc = (int)cudaErrorInvalidValue;
  auto go = [&](auto dt_) {
    constexpr int DD = decltype(dt_)::value;
    constexpr int SMEM = smem_bytes<DD>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        fa_tc_kernel<DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr != cudaSuccess) { rc = (int)attr; return; }
    fa_tc_kernel<DD><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), HQ, HKV, SQ, SKV, qs, ks, vs, causal, window, softcap, scale,
        q_offset);
    rc = (int)cudaGetLastError();
  };
  if (D == 16) go(Int<16>{});
  else if (D == 32) go(Int<32>{});
  else if (D == 64) go(Int<64>{});
  else if (D == 128) go(Int<128>{});
  else if (D == 256) go(Int<256>{});
  return rc;
}
