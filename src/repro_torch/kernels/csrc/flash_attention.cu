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
// dtype.
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
// the causal diagonal or left of the window are skipped.  Inputs are read
// through strides, so the model's (b, s, h, d) layout needs no transpose
// copy; the output is written in that layout.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block = threads per block
constexpr int BKV = 32;  // keys per shared-memory tile
constexpr int CH = 16;   // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;
};

template <int D, typename T>
__global__ void __launch_bounds__(BQ)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int HQ, int HKV,
              int SQ, int SKV, Strides qs, Strides ks, Strides vs, int causal,
              int window, float softcap, float scale) {
  __shared__ __align__(16) float k_t[BKV][D];
  __shared__ __align__(16) float v_t[BKV][D];
  const int q_start = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const int qi = q_start + threadIdx.x;
  const bool q_ok = qi < SQ;

  float qr[D], acc[D];
  const T* qp = q + b * qs.b + (long long)min(qi, SQ - 1) * qs.s + h * qs.h;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q_ok ? to_f32(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // Block-level relevance: keys <= the tile's last row (causal), keys
  // > its first row - window (sliding window).
  int kv_end = SKV;
  if (causal) kv_end = min(SKV, q_start + BQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_start - (window - 1)) / BKV * BKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    for (int i = threadIdx.x; i < BKV * D; i += BQ) {
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
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&k_t[c0 + j][d]);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        bool vis = true;
        if (causal) vis = vis && key <= qi;
        if (window > 0) vis = vis && key > qi - window;
        sc = vis ? sc : NEG_INF;
        s[j] = key < SKV ? sc : -INFINITY;  // past the end: not a key at all
        m_new = fmaxf(m_new, s[j]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = expf(s[j] - m_new);  // exp(-inf) = 0 past the end
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&v_t[c0 + j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
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
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv);
}

}  // namespace

extern "C" int flash_attention_fma(const void* q, const void* k, const void* v,
                                   void* out, int dt, int B, int HQ, int HKV,
                                   int SQ, int SKV, int D, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, int causal,
                                   int window, float softcap, float scale,
                                   void* stream) {
  if (HKV <= 0 || HQ % HKV != 0 || SQ <= 0 || SKV <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const dim3 grid((SQ + BQ - 1) / BQ, HQ, B);
  bool ok = false;
  with_dtype(dt, [&](auto* tp) {
    using T = elem_t<decltype(tp)>;
    auto go = [&](auto dt_) {
      constexpr int DD = decltype(dt_)::value;
      fa_fwd_kernel<DD, T><<<grid, BQ, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), HQ, HKV, SQ, SKV, qs,
          ks, vs, causal, window, softcap, scale);
      ok = true;
    };
    if (D == 16) go(Int<16>{});
    else if (D == 32) go(Int<32>{});
    else if (D == 64) go(Int<64>{});
    else if (D == 128) go(Int<128>{});
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
