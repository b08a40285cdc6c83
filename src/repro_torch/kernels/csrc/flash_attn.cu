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
// output takes the input dtype.  Two kernels: flash_fwd for f32 inputs,
// flash_fwd_tc for bf16 (the serving path's).
//
// Arithmetic: the reference's online softmax, step for step: masked scores
// are -1e30 (not -inf); per key tile m' = max(m, rowmax), p = exp(s - m'),
// alpha = exp(m - m'), l' = l alpha + rowsum(p) (over the f32 p),
// acc' = acc alpha + p v; at the end acc / max(l, 1e-30).  Products are
// summed in another order than on the TPU or in the dense plain version, so
// agreement is to a tolerance: f32 2e-5, bf16 2e-2 (the reference's own
// kernel tests) and, for flash_fwd_tc, 2 bf16 ulps of the plain version's
// output plus 1e-6 (repro_torch.testing.bf16_ulps): its f32 result is the
// reference's to f32 rounding, so the two bf16 roundings differ by at most
// one ulp, where dropping p1 and p2 reads hundreds.
//
// Bound: operations.  Each (query, key) pair inside the band costs D
// multiply-adds for q.k and D for p.v; at q [2, 4096, 16, 256], window
// 2048, causal, each product is 1.03e11 operations.  With bf16 inputs the
// reference upcasts q, k, v to f32 and multiplies: q.k multiplies bf16
// values, whose products f32 holds exactly, so bf16 tensor cores with f32
// accumulation compute the same products; p.v multiplies the f32 p by
// bf16 v, and p splits exactly into three bf16 terms p0 = bf16(p),
// p1 = bf16(p - p0), p2 = bf16(p - p0 - p1) (24 bits of significand; only
// probabilities deep in the subnormal range lose bits), each of whose
// products with v f32 holds exactly, so three bf16 tensor-core products
// compute the reference's p.v to within f32 rounding and summation order.
// One q.k and three p.v products at 989 TFLOP/s: 4 x 0.1042 ms = 0.4170 ms
// (pricing p.v at the f32 rate of 67 TFLOP/s instead, as before this
// kernel, gave 1.6430 ms).  Bytes (q, k, v, out) are 0.14 GB, 0.04 ms.
//
// flash_fwd (f32).  One CUDA block of 256 threads per (batch * head, tile
// of 64 queries); blockIdx.x runs over the heads, so the blocks in flight
// share their kv tiles through L2.  The block stages its query tile once,
// then walks only the 64-key tiles that meet the (causal, window) band: the
// reference skips the others through its grid, this kernel never visits
// them.  Each key tile's K and V rows are staged in shared memory (rows
// padded by 4 floats against bank conflicts) and shared by all warps.
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: for the
// scores it holds a 4 x 4 register tile (keys tx + 16j) built from 16-byte
// shared-memory loads; the row max and sum reduce over the 16 tx lanes by
// warp shuffles; the probabilities go to shared memory transposed; for
// p.v the thread holds its rows' accumulators over D/16 columns (in
// 16-byte groups where D allows, strided by 16 groups so a warp's loads
// hit distinct banks).  CUDA cores only.
//
// flash_fwd_tc (bf16).  One block of 384 threads per (batch * head, tile
// of 128 queries), blockIdx.x over the heads as above (for MQA the 16
// consecutive blocks of one kv head share its K/V tiles through L2): two
// consumer warpgroups, 64 queries each, and a producer warpgroup of which
// one thread issues the loads.  setmaxnreg moves registers from the
// producer (24 a thread) to the consumers (240).  The producer loads the
// query tiles and then the band's K and V tiles by TMA (four-dimensional
// tensor maps over [B, S, heads, D], so a head is read by index and rows
// at or past S arrive as zeros, which the k < S mask then ignores) into a
// ring of two stages, each with a "full" mbarrier (TMA's transaction bytes)
// and an "empty" one (the 256 consumer threads); both warpgroups read each
// K/V tile, which halves the loads from L2 against one warpgroup a block.
// Tiles stay bf16 in shared memory, swizzled at 128 bytes (32 or 64 for
// D = 16, 32) in chunks of 64 columns, the layout wgmma's descriptors
// name.  Per key tile a warpgroup computes s = q k^T with wgmma m64n64k16
// (Q and K from shared memory, both K-major), masks (only a tile at the
// band's edge) and takes the online softmax in registers on the
// accumulator (each row spread over the four lanes of a quad), scales acc
// by alpha (unless no row's maximum moved), splits p into its three bf16
// terms straight from the accumulator's layout into A fragments, and adds
// p v with three wgmma m64nDk16 per 16 keys, A from registers and V as the
// transposed (MN-major) B operand.  The two warpgroups run side by side,
// so one's softmax overlaps the other's products (making them take turns
// explicitly, with named barriers, measured slower).  At D = 256 a
// consumer thread holds the 128-float output accumulator, 32 scores and
// 48 fragment registers, within its 240; shared memory is 193 KB.
// D is a template parameter (16, 32, 64, 80, 128 or 256) in both kernels.
//
// D = 80 (HuBERT X-Large's 1280 / 16) is not a power of two.  flash_fwd
// gives each of its 16 column lanes five single columns.  flash_fwd_tc pads
// the row to 128 columns in shared memory: the tensor maps' boxes run past
// D and TMA fills columns 80-127 with zeros, so the tile is D = 128's; q k^T
// takes only the five k steps of the true 80 columns, and p v runs at
// N = 128 with the 80 true columns stored.  The padded p v does 1.6 times
// the function's work in the three split products, so the kernel can reach
// at most 320 / (80 + 3 * 128) = 69 % of the operations bound.  (Cutting
// the row into a 128-byte chunk and a 32-byte chunk, each with its own
// swizzle and tensor map, would run p v at N = 80 exactly, at the cost of a
// second layout in every descriptor.)
//
// C interface for ctypes: returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim the kernels are not built for.

#include <cuda.h>          // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of (ty, tx)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
// [64][D + 4]; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* x, int64_t b,
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int64_t S, int64_t H,
          int64_t Hkv, int causal, int64_t window, float softcap,
          float scale) {
  constexpr int DP = D + 4;              // padded f32 row of Q, K, V
  constexpr int PP = kBQ + 4;            // padded row of P^T
  // 16-byte groups where the 16 lanes' columns tile D in them, else 8 or
  // 4 bytes: D = 80 takes VEC 1, five columns a thread
  constexpr int VEC = D % 64 == 0 ? 4 : D % 32 == 0 ? 2 : 1;
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

  stage_rows<D>(Qs, q, b, q0, S, H, h);

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
    stage_rows<D>(Ks, k, b, k0, S, Hkv, g);
    stage_rows<D>(Vs, v, b, k0, S, Hkv, g);
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
    float* o = out + ((b * S + qp) * H + h) * D;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[(ch * 16 + tx) * VEC + e] = acc[i][ch * VEC + e] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t S, int64_t H, int64_t Hkv, int causal, int64_t window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * (D + 4) +
                                       kBK * (kBQ + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, Hkv,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: flash_fwd_tc, on the tensor cores (wgmma), K/V by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kGroups = 2;                // consumer warpgroups
constexpr int kBQ = 64 * kGroups;         // queries per block, 64 a group
constexpr int kBK = 64;                   // keys per tile
constexpr int kStages = 2;                // K/V ring
constexpr int kConsumers = 128 * kGroups;
// and a producer warpgroup, of which one thread issues the loads: with
// setmaxnreg registers move between whole warpgroups, and ptxas sizes the
// block's allocation for 3 x 128 threads (168 registers each); the
// producer's 24 and the consumers' 240 fill those 64,512 exactly
constexpr int kThreads = kConsumers + 128;

// Shared-memory geometry of a [64 rows][D] bf16 tile as TMA writes it: the
// row is padded to kPad columns (D = 80 to 128; a power of two stays as it
// is), cut into chunks of kRow bytes a row (128, or the whole row when it
// is shorter), each chunk a [64][kRow] block swizzled at kRow bytes, the
// layout wgmma's descriptors name (mode 1: 128 B, 2: 64 B, 3: 32 B).  The
// tensor map's box runs past D into the padding, which TMA fills with
// zeros.
template <int D>
struct Tile {
  static constexpr int kPad = D == 80 ? 128 : D;
  static constexpr int kRow = 2 * kPad < 128 ? 2 * kPad : 128;
  static constexpr int kChunks = 2 * kPad / kRow;
  static constexpr int kChunkBytes = 64 * kRow;
  static constexpr int kBytes = kChunks * kChunkBytes;
  static constexpr uint32_t kMode = kRow == 128 ? 1 : kRow == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : kRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B;
};

// One box of a 4-d tensor map, at (c0, c1, c2, c3) innermost first, into
// shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's shared-memory matrix descriptor: the start address and the
// leading and stride byte offsets in 16-byte units, the swizzle mode in the
// top two bits.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers that an asynchronous wgmma reads or writes: the compiler must
// neither move their uses across the wait nor reuse them before it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
// (D is overwritten when acc is 0).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float* d, uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float* d, uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float* d, uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float* d, uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a[0], a[1], a[2], a[3], db);
  if constexpr (D == 32) wgmma_rs_n32(d, a[0], a[1], a[2], a[3], db);
  if constexpr (D == 64) wgmma_rs_n64(d, a[0], a[1], a[2], a[3], db);
  if constexpr (D == 128) wgmma_rs_n128(d, a[0], a[1], a[2], a[3], db);
  if constexpr (D == 256) wgmma_rs_n256(d, a[0], a[1], a[2], a[3], db);
}

// (lo, hi) rounded to bf16 and packed as wgmma's A fragment takes a pair
// (lo in the low half); what rounding left off (exact in f32) goes back in
// (lo, hi).
__device__ __forceinline__ uint32_t split_bf16(float& lo, float& hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(h);
  lo = __fsub_rn(lo, f.x);
  hi = __fsub_rn(hi, f.y);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// Scale, soft cap and (kMask) the masks of the 64 x 64 score tile; mx
// takes the row maxima of this thread's entries (s[4i + e]: row e / 2, key
// k0 + 8i + col + e % 2).
template <bool kMask>
__device__ __forceinline__ void scores(float (&s)[32], float (&mx)[2], int k0,
                                       int col, const int (&qr)[2], int S,
                                       int causal, int window, float softcap,
                                       float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kp = k0 + 8 * i + col + (e & 1);
      float x = s[4 * i + e] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      if constexpr (kMask) {
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qr[r];
        if (window > 0) ok = ok && kp > qr[r] - window;
        x = ok ? x : kNegInf;
      }
      s[4 * i + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
}


// The band of key tiles that query rows [first, last] meet: [*lo, *hi].
__device__ __forceinline__ void band(int first, int last, int S, int causal,
                                     int window, int* lo, int* hi) {
  int k_lo = 0, k_hi = S - 1;
  if (window > 0 && first - window + 1 > 0) k_lo = first - window + 1;
  if (causal && last < k_hi) k_hi = last;
  *lo = k_lo / kBK;
  *hi = k_hi / kBK;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ out, int S, int H, int Hkv,
             int causal, int window, float softcap, float scale) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], q_full;
  // tiles start on 1024-byte boundaries, as the 128-byte swizzle needs
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + kGroups * T::kBytes;
  uint8_t* Vs = Ks + kStages * T::kBytes;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int q_rows = S - q0 < kBQ ? S - q0 : kBQ;   // rows of this block
  int t_lo, t_hi;
  band(q0, q0 + q_rows - 1, S, causal, window, &t_lo, &t_hi);
  const int n_tiles = t_hi - t_lo + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread loads the query tiles, then keeps the ring of K/V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const int q_tiles = (q_rows + 63) / 64;
      mbar_expect_tx(&q_full, q_tiles * T::kBytes);
      for (int w = 0; w < q_tiles; ++w)
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(Qs + w * T::kBytes + c * T::kChunkBytes, &tq, &q_full,
                   c * T::kRow / 2, h, q0 + 64 * w, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * T::kBytes);
        const int k0 = (t_lo + it) * kBK;
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(Ks + st * T::kBytes + c * T::kChunkBytes, &tk, &full[st],
                   c * T::kRow / 2, g, k0, b);
          tma_load(Vs + st * T::kBytes + c * T::kChunkBytes, &tv, &full[st],
                   c * T::kRow / 2, g, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumer warpgroup w owns query rows q0 + 64w .. + 63: its warp v
    // holds rows 16v + lane/4 and 8 below; in each row a lane holds the
    // column pairs 8i + 2 (lane % 4)
    const int w = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int qw = q0 + 64 * w;
    const int row0 = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
    const int qr[2] = {qw + row0, qw + row0 + 8};
    const int col = 2 * (lane % 4);
    // the tiles this warpgroup computes on (none if its rows start at S)
    int w_lo = 1, w_hi = 0;
    if (qw < S) band(qw, (qw + 64 < S ? qw + 64 : S) - 1, S, causal, window,
                     &w_lo, &w_hi);
    const uint64_t q_desc = desc(Qs + w * T::kBytes, 16, 8 * T::kRow,
                                 T::kMode);
    const uint64_t k_desc = desc(Ks, 16, 8 * T::kRow, T::kMode);
    const uint64_t v_desc = desc(Vs, T::kChunkBytes, 8 * T::kRow, T::kMode);
    // the accumulator spans the padded row; columns D.. stay zero
    float o[T::kPad / 2];
#pragma unroll
    for (int i = 0; i < T::kPad / 2; ++i) o[i] = 0.f;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
    mbar_wait(&q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, t = t_lo + it, k0 = t * kBK;
      mbar_wait(&full[st], (it / kStages) & 1);
      if (t < w_lo || t > w_hi) {        // outside this warpgroup's band
        mbar_arrive(&empty[st]);
        continue;
      }
      // descriptors advance in 16-byte units from opaque bases, so the
      // compiler keeps three register pairs, not one per k step
      uint64_t dq = q_desc, dk = k_desc + ((st * T::kBytes) >> 4),
               dv = v_desc + ((st * T::kBytes) >> 4);
      asm volatile("" : "+l"(dq), "+l"(dk), "+l"(dv));

      // s = q k^T over D in steps of 16 (32 bytes of a swizzled row); the
      // padding is zero in q and k and is left out
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      hold(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / (T::kRow / 32)) * T::kChunkBytes +
                        (kk % (T::kRow / 32)) * 32;
        wgmma_ss_n64(s, dq + (off >> 4), dk + (off >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      hold(s);

      // scale, soft cap, masks, online softmax (s[4i + e]: row e / 2, key
      // k0 + 8i + col + e % 2); a tile inside every row's band needs no
      // mask
      float mx[2] = {kNegInf, kNegInf};
      if (k0 + kBK <= S && (!causal || k0 + kBK - 1 <= qw) &&
          (window <= 0 || k0 > qw + 63 - window))
        scores<false>(s, mx, k0, col, qr, S, causal, window, softcap, scale);
      else
        scores<true>(s, mx, k0, col, qr, S, causal, window, softcap, scale);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r]);
        alpha[r] = expf(m_i[r] - m_new);
        m_i[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = expf(s[i] - m_i[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_i[r] = l_i[r] * alpha[r] + sum[r];
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < T::kPad / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      // p = p0 + p1 + p2 exactly, each a bf16 A fragment: for keys
      // 16j..16j+15 the pairs s[8j + 2r], s[8j + 2r + 1], r = 0..3
      uint32_t pa[3 * 4 * 4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float lo = s[8 * j + 2 * r], hi = s[8 * j + 2 * r + 1];
#pragma unroll
          for (int part = 0; part < 3; ++part)
            pa[(part * 4 + j) * 4 + r] = split_bf16(lo, hi);
        }

      // o += p v: V [key][d] is the B operand MN-major (transposed); keys
      // 16j.. start 16j rows in, 8-row groups 8 kRow bytes apart, d chunks
      // kChunkBytes apart; N is the padded row (v's padding is zero)
      hold(o);
      hold(pa);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          wgmma_pv<T::kPad>(o, &pa[(part * 4 + j) * 4],
                      dv + ((j * 16 * T::kRow) >> 4));
      wgmma_commit();
      wgmma_wait();
      hold(o);
      hold(pa);
      mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qr[r] >= S) continue;
      const float denom = fmaxf(l_i[r], 1e-30f);
      __nv_bfloat16* orow =
          out + ((static_cast<int64_t>(b) * S + qr[r]) * H + h) * D + col;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)      // the true columns only
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] / denom,
                                  o[4 * i + 2 * r + 1] / denom);
    }
  }
}

// x [B, S, heads, D] bf16 as a 4-d tensor map whose box is one chunk of 64
// rows of one head; rows at or past S, and columns at or past D (the
// padding of Tile<80>), read as zeros.
template <int D>
bool tensor_map(CUtensorMap* map, const void* x, int64_t B, int64_t S,
                int64_t heads) {
  using T = Tile<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * D),
                                 static_cast<cuuint64_t>(2 * D * heads),
                                 static_cast<cuuint64_t>(2 * D * heads * S)};
  const cuuint32_t box[4] = {T::kRow / 2, 1, kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t S, int64_t H, int64_t Hkv, int causal, int64_t window,
           float softcap, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  if (!tensor_map<D>(&mq, q, B, S, H) || !tensor_map<D>(&mk, k, B, S, Hkv) ||
      !tensor_map<D>(&mv, v, B, S, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (kGroups + 2 * kStages) * T::kBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  // a window of S or more masks nothing that S does not
  const int win = static_cast<int>(window < S ? window : S);
  flash_fwd_tc<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(Hkv), causal, win, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// fn(std::integral_constant<int, D>()) for a head dim the kernels are
// built for, else cudaErrorInvalidValue.
template <class F>
int with_head_dim(int64_t D, F fn) {
  switch (D) {
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 80: return fn(std::integral_constant<int, 80>());
    case 128: return fn(std::integral_constant<int, 128>());
    case 256: return fn(std::integral_constant<int, 256>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (flash_fwd), 1 = bfloat16 (flash_fwd_tc); q, k, v and
// out alike.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, int64_t B, int64_t S, int64_t H,
                          int64_t Hkv, int64_t D, int dtype, int causal,
                          int64_t window, float softcap, float scale,
                          void* stream) {
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_head_dim(D, [&](auto d) {
      return launch<decltype(d)::value>(q, k, v, out, B, S, H, Hkv, causal,
                                        window, softcap, scale, st);
    });
  if (dtype == 1)
    return with_head_dim(D, [&](auto d) {
      return tc::launch<decltype(d)::value>(q, k, v, out, B, S, H, Hkv,
                                            causal, window, softcap, scale,
                                            st);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}
