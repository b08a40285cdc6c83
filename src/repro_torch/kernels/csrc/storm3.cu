// Storm-family updates over flat buffers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/storm/kernel.py:
//   storm3_step    <- storm3_step_flat   (_storm3_step_kernel)
//       p' = p - lr[t]*m,   m' = decay[t]*(m - g_old)
//   storm3_update  <- storm3_update_flat (_storm3_kernel)
//       p' = p - lr[t]*m,   m' = g_new + decay[t]*(m - g_old)
//   sgd3_step      <- sgd3_step_flat     (_sgd3_kernel)
//       p' = p - lr[t]*g
//   momsgd3_step   <- momsgd3_step_flat  (_momsgd3_kernel)
//       m' = beta[t]*m + g,  p' = p - lr[t]*m'   (the updated momentum)
//   storm_update   <- storm_update_flat  (_storm_kernel, kernel.py:76)
//       p' = p - lr*m,      m' = g_new + decay*(m - g_old)
// with t = i / block: `block` is the flat layout's tile (65,536 elements by
// default), a layout constant that selects which per-tile table entry an
// element reads.  It is not the CUDA block size.  Buffers are client-major
// [M*N] flattenings, so the tables hold M*N/block entries.  storm_update
// has no tables: one (lr, decay) pair, passed by value, for the whole
// buffer; its momentum and gradients are f32 or bf16 (one dtype for the
// three, m' in it), p f32 or bf16, and N any length (the reference pads N
// to its 65,536-element tile; the padding only fed discarded elements, so
// this kernel masks the ragged tail instead).
//
// Bound: a single pass over memory with no reuse.  Per element, with bf16 p
// and f32 momenta and gradients: the STORM half step reads p, m, g_old and
// writes p', m' (16 B; 20 B with f32 p), the full update reads g_new as well
// (20 B / 24 B), plain SGD reads p, g and writes p' (8 B / 12 B), heavy-ball
// SGD reads p, m, g and writes p', m' (16 B / 20 B); storm_update moves
// what the full update moves (20 B with bf16 p and f32 streams, 24 B with
// f32 p; 12 B with bf16 p and bf16 streams).  A few flops per element, so
// the card's memory rate is the limit.
//
// Design: one grid-stride template for all five updates, in which each
// thread handles four consecutive elements with 16-byte loads of the f32
// streams (8-byte loads of bf16 ones).  The four share one tile when
// block % 4 == 0, so a thread reads its table entries once per group,
// through the read-only cache.  Indices are 64-bit.  Buffers whose length
// or alignment does not allow the vector path run the scalar loop.
// Arithmetic is f32 with explicit round-to-nearest intrinsics (no
// contraction into FMA), so the results equal the plain PyTorch versions bit
// for bit; bf16 stores round to nearest even.
//
// C interface for ctypes: every function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename P> __device__ __forceinline__ P from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load4(const float* p, int64_t g, float v[4]) {
  const float4 x = reinterpret_cast<const float4*>(p)[g];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int64_t g, float v[4]) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[g];
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, int64_t g, const float v[4]) {
  reinterpret_cast<float4*>(p)[g] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t g, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  reinterpret_cast<uint2*>(p)[g] = raw;
}

// The four updates, one element each: the plain version's operation order,
// each op rounded once.  kIn is the number of f32 input streams besides p
// (read in the order the C entry point takes them), kTables the number of
// per-tile tables (a, b), kMOut whether an f32 stream is written besides p'.

struct StormStep {        // s = (m, g_old), (a, b) = (lr, decay)
  static constexpr int kIn = 2, kTables = 2;
  static constexpr bool kMOut = true;
  __device__ static void apply(float p, const float* s, float lr, float decay,
                               float* p_out, float* m_out) {
    *p_out = __fsub_rn(p, __fmul_rn(lr, s[0]));
    *m_out = __fmul_rn(decay, __fsub_rn(s[0], s[1]));
  }
};

struct StormUpdate {      // s = (m, g_new, g_old), (a, b) = (lr, decay)
  static constexpr int kIn = 3, kTables = 2;
  static constexpr bool kMOut = true;
  __device__ static void apply(float p, const float* s, float lr, float decay,
                               float* p_out, float* m_out) {
    *p_out = __fsub_rn(p, __fmul_rn(lr, s[0]));
    *m_out = __fadd_rn(s[1], __fmul_rn(decay, __fsub_rn(s[0], s[2])));
  }
};

struct Sgd {              // s = (g), a = lr
  static constexpr int kIn = 1, kTables = 1;
  static constexpr bool kMOut = false;
  __device__ static void apply(float p, const float* s, float lr, float,
                               float* p_out, float*) {
    *p_out = __fsub_rn(p, __fmul_rn(lr, s[0]));
  }
};

struct MomSgd {           // s = (m, g), (a, b) = (lr, beta)
  static constexpr int kIn = 2, kTables = 2;
  static constexpr bool kMOut = true;
  __device__ static void apply(float p, const float* s, float lr, float beta,
                               float* p_out, float* m_out) {
    const float m = __fadd_rn(__fmul_rn(beta, s[0]), s[1]);
    *p_out = __fsub_rn(p, __fmul_rn(lr, m));
    *m_out = m;
  }
};

// The (a, b) coefficients of element i: the per-tile tables' entries when
// `ta` is given, else the pair (a0, b0) that holds for the whole buffer.
template <class Op>
__device__ __forceinline__ void coefs(const float* ta, const float* tb,
                                      float a0, float b0, int64_t i,
                                      int64_t block, float* a, float* b) {
  if (ta == nullptr) {
    *a = a0;
    *b = b0;
    return;
  }
  const int64_t t = i / block;
  *a = __ldg(ta + t);
  *b = 0.f;
  if constexpr (Op::kTables > 1) *b = __ldg(tb + t);
}

// P: the type of p and p'; S: the type of the other streams and of m'.
template <typename P, typename S, class Op>
__global__ void __launch_bounds__(kThreads)
update_vec4(const P* __restrict__ p, const S* __restrict__ s0,
            const S* __restrict__ s1, const S* __restrict__ s2,
            const float* __restrict__ ta, const float* __restrict__ tb,
            float a0, float b0, P* __restrict__ p_out,
            S* __restrict__ m_out, int64_t groups, int64_t block) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    float a, b;
    coefs<Op>(ta, tb, a0, b0, g * 4, block, &a, &b);
    float pv[4], sv[3][4] = {};
    load4(p, g, pv);
    load4(s0, g, sv[0]);
    if constexpr (Op::kIn > 1) load4(s1, g, sv[1]);
    if constexpr (Op::kIn > 2) load4(s2, g, sv[2]);
    float po[4], mo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float s[3] = {sv[0][k], sv[1][k], sv[2][k]};
      Op::apply(pv[k], s, a, b, &po[k], &mo[k]);
    }
    store4(p_out, g, po);
    if constexpr (Op::kMOut) store4(m_out, g, mo);
  }
}

template <typename P, typename S, class Op>
__global__ void __launch_bounds__(kThreads)
update_scalar(const P* __restrict__ p, const S* __restrict__ s0,
              const S* __restrict__ s1, const S* __restrict__ s2,
              const float* __restrict__ ta, const float* __restrict__ tb,
              float a0, float b0, P* __restrict__ p_out,
              S* __restrict__ m_out, int64_t begin, int64_t n,
              int64_t block) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = begin + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float a, b;
    coefs<Op>(ta, tb, a0, b0, i, block, &a, &b);
    float s[3] = {to_f32(s0[i]), 0.f, 0.f};
    if constexpr (Op::kIn > 1) s[1] = to_f32(s1[i]);
    if constexpr (Op::kIn > 2) s[2] = to_f32(s2[i]);
    float po, mo;
    Op::apply(to_f32(p[i]), s, a, b, &po, &mo);
    p_out[i] = from_f32<P>(po);
    if constexpr (Op::kMOut) m_out[i] = from_f32<S>(mo);
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

int grid_for(int64_t work) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t resident = static_cast<int64_t>(sms) * (2048 / kThreads);
  const int64_t need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < resident ? (need > 0 ? need : 1) : resident);
}

// The vector loop over the largest multiple of 4 elements, then the scalar
// loop over the tail (or over everything when the vector path is barred).
// Without tables (ta null) the coefficients are (a0, b0) and `block` is
// not read.
template <typename P, typename S, class Op>
int launch(const void* p, const void* s0, const void* s1, const void* s2,
           const float* ta, const float* tb, float a0, float b0, void* p_out,
           void* m_out, int64_t n, int64_t block, cudaStream_t stream) {
  const P* pp = static_cast<const P*>(p);
  P* po = static_cast<P*>(p_out);
  const S *q0 = static_cast<const S*>(s0), *q1 = static_cast<const S*>(s1),
          *q2 = static_cast<const S*>(s2);
  S* mo = static_cast<S*>(m_out);
  const bool vec = (ta == nullptr || block % 4 == 0) &&
                   aligned(p, 4 * sizeof(P)) && aligned(p_out, 4 * sizeof(P)) &&
                   aligned(s0, 4 * sizeof(S)) && aligned(s1, 4 * sizeof(S)) &&
                   aligned(s2, 4 * sizeof(S)) && aligned(m_out, 4 * sizeof(S));
  int64_t done = 0;
  if (vec && n >= 4) {
    const int64_t groups = n / 4;
    update_vec4<P, S, Op><<<grid_for(groups), kThreads, 0, stream>>>(
        pp, q0, q1, q2, ta, tb, a0, b0, po, mo, groups, block);
    done = groups * 4;
  }
  if (done < n) {
    update_scalar<P, S, Op><<<grid_for(n - done), kThreads, 0, stream>>>(
        pp, q0, q1, q2, ta, tb, a0, b0, po, mo, done, n, block);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int dispatch(int p_is_bf16, const void* p, const float* s0, const float* s1,
             const float* s2, const float* ta, const float* tb, void* p_out,
             float* m_out, int64_t n, int64_t block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p_is_bf16
      ? launch<__nv_bfloat16, float, Op>(p, s0, s1, s2, ta, tb, 0.f, 0.f,
                                         p_out, m_out, n, block, s)
      : launch<float, float, Op>(p, s0, s1, s2, ta, tb, 0.f, 0.f, p_out,
                                 m_out, n, block, s);
}

template <typename S>
int dispatch_scalar(int p_is_bf16, const void* p, const void* m,
                    const void* g_new, const void* g_old, float lr,
                    float decay, void* p_out, void* m_out, int64_t n,
                    cudaStream_t s) {
  return p_is_bf16
      ? launch<__nv_bfloat16, S, StormUpdate>(p, m, g_new, g_old, nullptr,
                                              nullptr, lr, decay, p_out,
                                              m_out, n, 1, s)
      : launch<float, S, StormUpdate>(p, m, g_new, g_old, nullptr, nullptr,
                                      lr, decay, p_out, m_out, n, 1, s);
}

}  // namespace

extern "C" {

int storm3_step(int p_is_bf16, const void* p, const float* m, const float* g_old,
                const float* lrs, const float* decays, void* p_out, float* m_out,
                int64_t n, int64_t block, void* stream) {
  return dispatch<StormStep>(p_is_bf16, p, m, g_old, nullptr, lrs, decays,
                             p_out, m_out, n, block, stream);
}

int storm3_update(int p_is_bf16, const void* p, const float* m, const float* g_new,
                  const float* g_old, const float* lrs, const float* decays,
                  void* p_out, float* m_out, int64_t n, int64_t block, void* stream) {
  return dispatch<StormUpdate>(p_is_bf16, p, m, g_new, g_old, lrs, decays,
                               p_out, m_out, n, block, stream);
}

int sgd3_step(int p_is_bf16, const void* p, const float* g, const float* lrs,
              void* p_out, int64_t n, int64_t block, void* stream) {
  return dispatch<Sgd>(p_is_bf16, p, g, nullptr, nullptr, lrs, nullptr,
                       p_out, nullptr, n, block, stream);
}

int momsgd3_step(int p_is_bf16, const void* p, const float* m, const float* g,
                 const float* lrs, const float* betas, void* p_out, float* m_out,
                 int64_t n, int64_t block, void* stream) {
  return dispatch<MomSgd>(p_is_bf16, p, m, g, nullptr, lrs, betas,
                          p_out, m_out, n, block, stream);
}

// m, g_new, g_old and m' share one dtype (m_is_bf16); lr and decay hold for
// every element.
int storm_update(int p_is_bf16, int m_is_bf16, const void* p, const void* m,
                 const void* g_new, const void* g_old, float lr, float decay,
                 void* p_out, void* m_out, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m_is_bf16
      ? dispatch_scalar<__nv_bfloat16>(p_is_bf16, p, m, g_new, g_old, lr,
                                       decay, p_out, m_out, n, s)
      : dispatch_scalar<float>(p_is_bf16, p, m, g_new, g_old, lr, decay,
                               p_out, m_out, n, s);
}

}  // extern "C"
