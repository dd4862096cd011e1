// Flash-attention forward for Hopper (sm_90a) on the CUDA cores: the fp32
// path, online softmax and products in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:103 flash_attention (body _fa_kernel :30) for fp32
// inputs: causal masking, GQA through kv-head indexing (h // groups, no K/V
// repeat), sliding window, logit softcap and the l == 0 guard, forward only
// (the JAX package has no flash backward either).  bf16 inputs, as on the
// serving path, go to fa_tc_kernel (flash_attention_tc.cu, tensor cores);
// fp32 stays here because the fp32 paged-decode parity probe is held to
// 1e-5, which TF32 or bf16 products would break.  The wrapper chooses by
// dtype, so this library instantiates the kernel for fp32 alone (a bf16
// set would double its build, the slowest of the port's, and never run).
//
// What bounds it on an H100: at granite-moe-3b's serving shapes (24 query
// heads over 8 KV heads, head_dim 64, prompts of at most 512 tokens) the
// work is ~4*s^2/2*d FLOPs per head, a few hundred MFLOP per layer, and the
// bytes are q/k/v/out once; both bounds are microseconds, so this kernel is
// limited by its own CUDA-core arithmetic and occupancy, not by the card.
//
// Design: one 64-thread block per (query tile of 64 rows, query head,
// batch); each thread owns one query row, holding q and its fp32
// accumulator in registers.  The TPU's sequential KV grid axis becomes a
// loop inside the block over 32-key K/V tiles staged in shared memory as
// fp32 (every thread reads the same key: broadcast).  Softmax state is
// updated every 16 keys with the TPU kernel's rule: scores of masked keys
// are -1e30 and still enter exp(s - m), so rows agree with the TPU kernel;
// keys past the sequence end are excluded outright.  KV tiles wholly above
// the causal diagonal or left of the window are skipped.  A query offset
// (the reference attention's q_offset) places query row i at position
// q_offset + i against keys 0 .. SKV - 1, for a rank that holds a slice of
// the sequence's queries and the whole sequence's keys; the masks and the
// tile skip read that position, so q_offset = 0 is the kernel it was.
// Inputs are read
// through strides, so the model's (b, s, h, d) layout needs no transpose
// copy; the output is written in that layout.
//
// d = 256 (gemma2-9b) has its own layout (Layout<256>): one thread a row
// would hold 512 fp32 registers of q and accumulator, and two 32-key fp32
// tiles of K and V would take 64 KB, past the 48 KB of static shared
// memory (ptxas refuses it, and with it the whole library).  So four
// neighbouring threads share a row, each holding a quarter of its q and
// accumulator (float4 chunks four apart, so the four read neighbouring
// 16-byte bank groups of a key row), their partial dot products summed
// by two xor shuffles (every lane gets the same sum, so the four keep one
// softmax state); and a K/V tile is 16 keys, 32 KB.  Products and sums
// stay fp32.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int CH = 16;   // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;
};

// Per head dim: threads that share a query row (TPR) and keys per
// shared-memory tile (BKV).
template <int D> struct Layout {
  static constexpr int TPR = 1, BKV = 32;
};
template <> struct Layout<256> {
  static constexpr int TPR = 4, BKV = 16;
};

template <int D, typename T>
__global__ void __launch_bounds__(BQ * Layout<D>::TPR)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int HQ, int HKV,
              int SQ, int SKV, Strides qs, Strides ks, Strides vs, int causal,
              int window, float softcap, float scale, int q_offset) {
  constexpr int TPR = Layout<D>::TPR, BKV = Layout<D>::BKV, THREADS = BQ * TPR;
  constexpr int NC = D / 4 / TPR;  // float4 chunks of the row a thread holds
  static_assert(2 * BKV * D * 4 <= 48 * 1024, "static shared memory");
  __shared__ __align__(16) float k_t[BKV][D];
  __shared__ __align__(16) float v_t[BKV][D];
  const int q_start = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const int part = threadIdx.x % TPR;  // this thread's chunks: part + c * TPR
  const int qi = q_start + threadIdx.x / TPR;
  const int qpos = q_offset + qi;  // the row's global position, as the masks see it
  const bool q_ok = qi < SQ;

  float qr[4 * NC], acc[4 * NC];
  const T* qp = q + b * qs.b + (long long)min(qi, SQ - 1) * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = q_ok ? to_f32(qp[4 * (part + c * TPR) + e]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  float m = NEG_INF, l = 0.f;

  // Block-level relevance: keys <= the tile's last row (causal), keys
  // > its first row - window (sliding window), rows at their global
  // positions q_offset + i.
  int kv_end = SKV;
  if (causal) kv_end = min(SKV, q_offset + q_start + BQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + q_start - (window - 1)) / BKV * BKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D, key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < SKV) {
        kv = to_f32(k[b * ks.b + (long long)key * ks.s + hk * ks.h + c]);
        vv = to_f32(v[b * vs.b + (long long)key * vs.s + hk * vs.h + c]);
      }
      k_t[r][c] = kv;
      v_t[r][c] = vv;
    }
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < BKV; c0 += CH) {
      float s[CH];
      float m_new = m;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int key = k0 + c0 + j;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&k_t[c0 + j][4 * (part + c * TPR)]);
          dot = fmaf(qr[4 * c], kk.x, dot);
          dot = fmaf(qr[4 * c + 1], kk.y, dot);
          dot = fmaf(qr[4 * c + 2], kk.z, dot);
          dot = fmaf(qr[4 * c + 3], kk.w, dot);
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        bool vis = true;
        if (causal) vis = vis && key <= qpos;
        if (window > 0) vis = vis && key > qpos - window;
        sc = vis ? sc : NEG_INF;
        s[j] = key < SKV ? sc : -INFINITY;  // past the end: not a key at all
        m_new = fmaxf(m_new, s[j]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < 4 * NC; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = expf(s[j] - m_new);  // exp(-inf) = 0 past the end
        l += p;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&v_t[c0 + j][4 * (part + c * TPR)]);
          acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (!q_ok) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* op = out + (((long long)b * SQ + qi) * HQ + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[4 * (part + c * TPR) + e] = from_f32<T>(acc[4 * c + e] * inv);
}

}  // namespace

extern "C" int flash_attention_fma(const void* q, const void* k, const void* v,
                                   void* out, int dt, int B, int HQ, int HKV,
                                   int SQ, int SKV, int D, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, int causal,
                                   int window, float softcap, float scale,
                                   int q_offset, void* stream) {
  if (dt != kF32 || HKV <= 0 || HQ % HKV != 0 || SQ <= 0 || SKV <= 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const dim3 grid((SQ + BQ - 1) / BQ, HQ, B);
  bool ok = false;
  auto go = [&](auto d_) {
    constexpr int DD = decltype(d_)::value;
    fa_fwd_kernel<DD, float><<<grid, BQ * Layout<DD>::TPR, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), HQ, HKV, SQ, SKV, qs,
        ks, vs, causal, window, softcap, scale, q_offset);
    ok = true;
  };
  if (D == 16) go(Int<16>{});
  else if (D == 32) go(Int<32>{});
  else if (D == 64) go(Int<64>{});
  else if (D == 128) go(Int<128>{});
  else if (D == 256) go(Int<256>{});
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
