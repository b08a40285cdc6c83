// Causal / sliding-window GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash/kernel.py:
//   flash_attn  <- flash_attention_bh (_flash_kernel, kernel.py:91), with the
//                  layout work of repro/kernels/flash/ops.py:flash_attention
//       out[b, q, h] = sum_k softmax_k(cap(scale * q[b,q,h] . k[b,k,g])) v[b,k,g]
// over q: [B, S, H, D], k, v: [B, S, Hkv, D] (f32 or bf16, contiguous), with
// query head h reading kv head g = h / (H / Hkv) by index (the reference
// repeats k and v to H heads first; the function is the same), cap the
// optional tanh soft cap, and key k of query q masked unless k < S,
// k <= q (causal) and k > q - window (window > 0).  Computed in f32; the
// output takes the input dtype.
//
// Arithmetic: the reference's online softmax, step for step: masked scores
// are -1e30 (not -inf); per key tile m' = max(m, rowmax), p = exp(s - m'),
// alpha = exp(m - m'), l' = l alpha + rowsum(p), acc' = acc alpha + p v; at
// the end acc / max(l, 1e-30).  Products are summed in another order than on
// the TPU or in the dense plain version, so agreement is to a tolerance
// (f32 2e-5, bf16 2e-2, the reference's own kernel tests).
//
// Bound: operations.  Each (query, key) pair inside the band costs D
// multiply-adds for q.k and D for p.v; at q [2, 4096, 16, 256], window
// 2048, causal, each half is 1.03e11 operations.  With bf16 inputs, q.k
// multiplies bf16 values, whose products f32 holds exactly, so the same
// function runs on the bf16 tensor cores at 989 TFLOP/s: 0.10 ms.  p.v
// multiplies f32 probabilities and is held to the 67 TFLOP/s outside the
// tensor cores: 1.54 ms.  Together 1.64 ms (3.08 ms if all ran at the f32
// rate; 0.21 ms if all ran at the bf16 tensor-core rate, the ceiling of a
// later wgmma redesign that rounds p to bf16).  Bytes (q, k, v, out) are
// 0.14 GB, 0.04 ms.
//
// Design.  One CUDA block of 256 threads per (batch * head, tile of 64
// queries); blockIdx.x runs over the heads, so the blocks in flight share
// their kv tiles through L2.  The block stages its query tile once, then
// walks only the 64-key tiles that meet the (causal, window) band: the
// reference skips the others through its grid, this kernel never visits
// them.  Each key tile's K and V rows are staged in shared memory (as f32,
// rows padded by 4 floats against bank conflicts) and shared by all warps.
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: for the
// scores it holds a 4 x 4 register tile (keys tx + 16j) built from 16-byte
// shared-memory loads; the row max and sum reduce over the 16 tx lanes by
// warp shuffles; the probabilities go to shared memory transposed; for
// p.v the thread holds its rows' accumulators over D/16 columns (in
// 16-byte groups where D allows, strided by 16 groups so a warp's loads
// hit distinct banks).  No tensor cores, TMA or pipelining: the first
// version is right and simple.  D is a template parameter (16, 32, 64,
// 128 or 256).
//
// C interface for ctypes: returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim the kernel is not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of (ty, tx)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VEC consecutive floats of shared memory (VEC = 1, 2 or 4).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

// rows [row0, row0 + 64) of one head of x [B, S, heads, D] into dst
// [64][D + 4] as f32; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* x, int64_t b,
                                           int64_t row0, int64_t S,
                                           int64_t heads, int64_t head) {
  constexpr int DP = D + 4;
  constexpr int G = D / 4;               // 4-element groups per row
  for (int idx = threadIdx.x; idx < kBQ * G; idx += kThreads) {
    const int r = idx / G, d = (idx - r * G) * 4;
    const int64_t s = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) v = load4(x + ((b * S + s) * heads + head) * D + d);
    *reinterpret_cast<float4*>(dst + r * DP + d) = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int64_t S, int64_t H,
          int64_t Hkv, int causal, int64_t window, float softcap,
          float scale) {
  constexpr int DP = D + 4;              // padded f32 row of Q, K, V
  constexpr int PP = kBQ + 4;            // padded row of P^T
  constexpr int VEC = D >= 64 ? 4 : D / 16;
  constexpr int CHUNKS = D / (16 * VEC); // column groups per thread
  constexpr int NC = D / 16;             // columns per thread

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * DP;             // P^T: [key][query]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh - b * H;
  const int64_t g = h / (H / Hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBQ;
  const int64_t q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;

  stage_rows<T, D>(Qs, q, b, q0, S, H, h);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  // key tiles that meet the band of this query tile
  int64_t k_lo = 0, k_hi = S - 1;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  if (causal && q_last < k_hi) k_hi = q_last;

  for (int64_t kt = k_lo / kBK; kt <= k_hi / kBK; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();                     // the last tile's Ks/Vs/Ps are read
    stage_rows<T, D>(Ks, k, b, k0, S, Hkv, g);
    stage_rows<T, D>(Vs, v, b, k0, S, Hkv, g);
    __syncthreads();

    // scores of rows 4ty + i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(Qs + (ty * 4 + i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    // scale, soft cap, masks, online softmax
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * PP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc = acc * alpha + P V over this tile's keys
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha[i];
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      const float4 p = load4(Ps + c * PP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int ch = 0; ch < CHUNKS; ++ch) {
        float vv[VEC];
        load_vec<VEC>(Vs + c * DP + (ch * 16 + tx) * VEC, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][ch * VEC + e] += pr[i] * vv[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((b * S + qp) * H + h) * D;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store1(o + (ch * 16 + tx) * VEC + e, acc[i][ch * VEC + e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t S, int64_t H, int64_t Hkv, int causal, int64_t window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * (D + 4) +
                                       kBK * (kBQ + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, causal,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int64_t D, const void* q, const void* k, const void* v,
             void* out, int64_t B, int64_t S, int64_t H, int64_t Hkv,
             int causal, int64_t window, float softcap, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, int64_t B, int64_t S, int64_t H,
                          int64_t Hkv, int64_t D, int dtype, int causal,
                          int64_t window, float softcap, float scale,
                          void* stream) {
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, B, S, H, Hkv, causal, window,
                           softcap, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, S, H, Hkv, causal,
                                   window, softcap, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
