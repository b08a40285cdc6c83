// RG-LRU linear recurrence scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/lru/kernel.py:
//   lru_scan  <- lru_scan_padded (_lru_kernel, kernel.py:48), with the
//                padding of repro/kernels/lru/ops.py:lru_scan
//       h[b, t, c] = a[b, t, c] * h[b, t-1, c] + b[b, t, c],  h[b, -1, c] = h0[b, c]
// over a, b: [B, S, C] f32 (C contiguous), h0: [B, C] f32 or absent (zeros).
//
// Arithmetic: one rounded product and one rounded sum per step,
// __fadd_rn(__fmul_rn(a, h), b), never contracted into an FMA, so the
// kernel equals the plain sequential version (kernels/lru/ref.py, a mul then
// an add per step) bit for bit.  The TPU kernel pads S to its time tile with
// a = 1, b = 0 and C to its channel block; both are no-ops on the state, so
// this kernel takes any S and C unpadded.
//
// Bound: memory.  Each element reads a and b and writes h, 12 B, with two
// operations; at [2, 4096, 4096] that is 403 MB, 0.120 ms at 3.35 TB/s.
//
// Design.  Two kernels; the wrapper (kernels/lru/ops.py:scan_variant)
// picks one by shape and counts each apart.  Both keep the sequential
// chain, one thread per (batch, channel), so both are bit for bit the
// plain version: a time-chunked two-pass scan would round otherwise.
//
// lru_scan_tma (kernel tma_ring_scan; C % 4 == 0, a and b 16-byte aligned:
// TMA's global strides are multiples of 16 bytes). lru_scan_lanes keeps 2 x
// 16 loads in flight per thread and then runs the dependent chain; at the
// path's 8,192 threads that is ~8 KB in flight per SM, where the memory rate
// times its latency wants ~20-25 KB (3.35 TB/s x ~1 us / 132 SMs): it ran at
// 25 % of the rate (H100 80GB HBM3, 700 W).  Here the loads leave the threads
// altogether.  One CTA per (batch, block of kCB = 64 channels): a producer
// warp, one of whose threads issues TMA loads of [kTT = 64 time steps x 64
// channels] boxes of a and of b (16 KB each; a 3-d tensor map over [B, S,
// C], rows at or past S and channels at or past C filled with zeros) into a
// ring of kStages = 6 stages (192 KB, one CTA an SM), each stage with a
// "full" mbarrier (TMA's transaction bytes) and an "empty" one (the 64
// consumer threads).  The consumers, one per channel, walk each tile's rows
// from shared memory (neighbouring lanes, neighbouring banks) with the chain
// unchanged and store h with coalesced 4-byte stores (a warp's row is one
// 128-byte line); rows at or past S and channels at or past C are never
// stored.  The chain is short (4,096 dependent multiply-adds at ~8 cycles,
// ~20 us); up to 192 KB in flight per SM keeps the loads ahead of it.
//
// lru_scan_lanes (kernel rg_lru_scan; any shape).  One thread per (batch,
// channel) walks time, neighbouring threads on neighbouring channels (each
// warp's load and store one coalesced line); the time loop is unrolled by
// kUnroll, the loads of a whole chunk issued before its dependent chain.
//
// C interface for ctypes: every function returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rg_lru_scan(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ h0, float* __restrict__ h_out,
            int64_t S, int64_t C, int64_t lanes) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int64_t bi = lane / C, c = lane - bi * C;
  const int64_t base = bi * S * C + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h_out + base;
  float h = h0 == nullptr ? 0.f : h0[lane];

  int64_t t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[(t + u) * C];
      bv[u] = bp[(t + u) * C];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      hp[(t + u) * C] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(ap[t * C], h), bp[t * C]);
    hp[t * C] = h;
  }
}

constexpr int kCB = 64;                  // channels of a CTA
constexpr int kTT = 64;                  // time steps of a tile
constexpr int kStages = 6;
constexpr int kTileFloats = kTT * kCB;
constexpr uint32_t kTileBytes = kTileFloats * sizeof(float);
constexpr int kTmaThreads = kCB + 32;    // the consumers and a producer warp
constexpr size_t kTmaSmem = 2 * kStages * kTileBytes + 128;

// One box of a 3-d tensor map, at (c0, c1, c2) innermost first, into
// shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(kTmaThreads, 1)
tma_ring_scan(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb,
             const float* __restrict__ h0, float* __restrict__ h_out, int S,
             int C) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  float* as = reinterpret_cast<float*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  float* bs = as + kStages * kTileFloats;
  const int c0 = blockIdx.x * kCB, bi = blockIdx.y;
  const int n_tiles = (S + kTT - 1) / kTT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCB);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kCB) {
    if (threadIdx.x == kCB) {            // the producer
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        tma_load(as + st * kTileFloats, &ta, &full[st], c0, it * kTT, bi);
        tma_load(bs + st * kTileFloats, &tb, &full[st], c0, it * kTT, bi);
      }
    }
    return;
  }

  const int c = c0 + threadIdx.x;
  const bool store = c < C;
  float h = (h0 != nullptr && store) ? h0[static_cast<int64_t>(bi) * C + c]
                                     : 0.f;
  float* hp = h_out + static_cast<int64_t>(bi) * S * C + c;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const float* ar = as + st * kTileFloats + threadIdx.x;
    const float* br = bs + st * kTileFloats + threadIdx.x;
    const int rows = S - it * kTT < kTT ? S - it * kTT : kTT;
    if (rows == kTT) {
#pragma unroll 16
      for (int r = 0; r < kTT; ++r) {
        h = __fadd_rn(__fmul_rn(ar[r * kCB], h), br[r * kCB]);
        if (store) hp[static_cast<int64_t>(r) * C] = h;
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        h = __fadd_rn(__fmul_rn(ar[r * kCB], h), br[r * kCB]);
        if (store) hp[static_cast<int64_t>(r) * C] = h;
      }
    }
    mbar_arrive(&empty[st]);
    hp += static_cast<int64_t>(kTT) * C;
  }
}

// x [B, S, C] f32 as a 3-d tensor map whose box is [kTT rows x kCB
// channels] of one batch; what lies past S or C reads as zeros.
bool tensor_map(CUtensorMap* map, const void* x, int64_t B, int64_t S,
                int64_t C) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(4 * C),
                                 static_cast<cuuint64_t>(4 * C * S)};
  const cuuint32_t box[3] = {kCB, kTT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a, b [B, S, C] f32, h0 [B, C] f32 or null, h_out [B, S, C].
extern "C" int lru_scan_lanes(const void* a, const void* b, const void* h0,
                              void* h_out, int64_t B, int64_t S, int64_t C,
                              void* stream) {
  const int64_t lanes = B * C;
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  if (lanes > 0 && S > 0) {
    rg_lru_scan<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<float*>(h_out), S, C,
        lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

// As lru_scan_lanes, for C % 4 == 0 and a, b 16-byte aligned.
extern "C" int lru_scan_tma(const void* a, const void* b, const void* h0,
                            void* h_out, int64_t B, int64_t S, int64_t C,
                            void* stream) {
  if (C % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || S > INT32_MAX ||
      C > INT32_MAX || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * C == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, a, B, S, C) || !tensor_map(&mb, b, B, S, C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      tma_ring_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTmaSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((C + kCB - 1) / kCB),
                  static_cast<unsigned>(B));
  tma_ring_scan<<<grid, kTmaThreads, kTmaSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      ma, mb, static_cast<const float*>(h0), static_cast<float*>(h_out),
      static_cast<int>(S), static_cast<int>(C));
  return static_cast<int>(cudaGetLastError());
}
