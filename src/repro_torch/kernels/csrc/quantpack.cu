// Per-tile symmetric int8 pack / unpack over flat buffers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/storm/quantpack.py:
//   quantpack    <- quantpack_flat   (_quantpack_kernel, quantpack.py:50)
//       scale[t] = max|x| over tile t * (1/127),  safe = scale > 0 ? scale : 1
//       q[i]     = clamp(rint(x[i] / safe), -127, 127)    as int8
//   quantunpack  <- quantunpack_flat (_quantunpack_kernel, quantpack.py:68)
//       x[i]     = q[i] * scale[i / block]                as f32
// with t = i / block: `block` is the flat layout's tile (65,536 elements by
// default), not the CUDA block size.  Buffers are client-major [M*N]
// flattenings, so there are M*N/block tiles and scales.
//
// Arithmetic: the reference's compiled arithmetic, op for op.  XLA rewrites
// the division of the tile max by the constant 127 into a product with the
// f32 reciprocal, so the scale is __fmul_rn(amax, 1.0f/127.0f); the
// quantized value is a true IEEE division, rounded half to even (rintf);
// the unpack is one rounded product, as the TPU kernel writes it.
// Built without --use_fast_math, so '/' and rintf stay IEEE.
//
// Non-finite inputs follow the reference.  Its max propagates a NaN, so
// every max here is PTX max.NaN.f32 (per thread, across the warp, the
// block and the cluster): a tile holding a NaN has scale NaN, and then
// safe = 1 (NaN > 0 is false) as in the reference's where.  A tile holding
// an Inf has scale Inf.  A NaN quotient (the NaN itself, or +-Inf / Inf)
// quantizes to 0, where fminf/fmaxf would clamp it to -127; +-Inf over a
// finite divisor clamps to +-127.  So such a tile unpacks to all NaN
// (0 * Inf, q * NaN), as the reference's does.
//
// Bound: memory.  quantpack reads 4 B and writes 1 B per element plus 4 B
// per tile; quantunpack reads 1 B and writes 4 B per element and reads 4 B
// per tile.  A handful of operations per element.
//
// Design of quantpack: the tile's max must be known before any element is
// quantized, so a kernel that reads the tile from device memory twice
// moves 9 B an element against the bound's 5 B.  pack_cluster reads it
// once.  An f32 tile of the path (65,536 elements, 256 KB) does not fit
// one CTA's 227 KB of shared memory, so a thread-block cluster of CL CTAs
// shares it.  The wrapper picks CL (quantpack.py:cluster_size: 8 CTAs of
// 8,192 elements, 32 KB, on the path); the launch checks that a part fits
// the shared memory a CTA takes by default.  Each CTA of 128
// threads pulls its part into shared memory with one 1-D bulk copy
// (cp.async.bulk, completion on an mbarrier), takes the part's max and
// publishes it; after a cluster barrier every CTA reads the CL partials
// through distributed shared memory (mapa + ld.shared::cluster) and forms
// the same scale; rank 0 writes it; each CTA quantizes its part from
// shared memory (coalesced 4-byte stores of four int8 values), then meets
// the others at a second cluster barrier, so no CTA leaves while another
// may still read its partial.  Small CTAs are the point: six fit an SM,
// so while some wait at their barriers or quantize, others' copies are in
// flight.  The shape was chosen by timing variants (CTAs of 64 to 256
// threads, parts of 32 or 64 KB, the second barrier's arrival before or
// after the stores, persistent clusters walking many tiles through a ring
// of parts, clusters of 16, four copies a part; PERF.md §6): each of the
// others was slower.  pack_tiles, the two-pass kernel,
// takes the tiles the cluster cannot (more than 8 x 8,192 elements, a part
// that is not a multiple of 4 elements, x not 16-byte or q not 4-byte
// aligned): one CUDA block per tile, pass 1 a block-stride max with
// 16-byte loads where alignment allows, pass 2 reads the tile again (from
// L2 when the tiles in flight fit in it).  The wrapper
// (kernels/storm/quantpack.py) picks the kernel and counts each apart.
// quantunpack is a grid-stride elementwise pass: 4-byte loads of four int8
// values, 16-byte stores, and a scalar tail.
//
// C interface for ctypes: every function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kPackThreads = 512;
constexpr int kClusterThreads = 128;
constexpr int kUnpackThreads = 256;
constexpr int kMaxCluster = 8;   // the portable cluster size

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// max that returns NaN when either operand is NaN (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                 nan_max(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The block's max of v, in every thread; `partial` holds a float per warp.
__device__ __forceinline__ float block_max(float v, float* partial) {
  v = warp_max(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x / 32) ? partial[lane] : 0.f;
  return warp_max(v);
}

__device__ __forceinline__ int8_t quantize(float x, float safe) {
  const float r = rintf(__fdiv_rn(x, safe));
  if (r != r) return 0;                  // a NaN quotient, as the reference
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

__device__ __forceinline__ char4 quantize4(float4 v, float safe) {
  return make_char4(quantize(v.x, safe), quantize(v.y, safe),
                    quantize(v.z, safe), quantize(v.w, safe));
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(amax, 1.0f / 127.0f);
}

__global__ void __launch_bounds__(kPackThreads)
pack_tiles(const float* __restrict__ x, int8_t* __restrict__ q,
           float* __restrict__ scales, int64_t block, bool vec) {
  __shared__ float partial[kPackThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const float* xt = x + base;
  int8_t* qt = q + base;

  // pass 1: max |x| over the tile
  float amax = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xt);
    for (int64_t g = threadIdx.x; g < block / 4; g += blockDim.x)
      amax = nan_max(amax, abs_max4(x4[g]));
  } else {
    for (int64_t i = threadIdx.x; i < block; i += blockDim.x)
      amax = nan_max(amax, fabsf(xt[i]));
  }
  const float scale = scale_of(block_max(amax, partial));
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
  const float safe = scale > 0.f ? scale : 1.f;

  // pass 2: quantize
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xt);
    char4* q4 = reinterpret_cast<char4*>(qt);
    for (int64_t g = threadIdx.x; g < block / 4; g += blockDim.x)
      q4[g] = quantize4(x4[g], safe);
  } else {
    for (int64_t i = threadIdx.x; i < block; i += blockDim.x)
      qt[i] = quantize(xt[i], safe);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `local`'s counterpart in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float load_from_rank(const float* local,
                                                uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// One cluster of `cl` CTAs per tile; CTA `rank` holds elements
// [rank * part, (rank + 1) * part) of it in shared memory.
__global__ void __launch_bounds__(kClusterThreads)
pack_cluster(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scales, int64_t block, int64_t part,
             int cl) {
  extern __shared__ float4 xs[];           // part floats
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[kClusterThreads / 32];
  __shared__ float cta_max, tile_max;
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int64_t tile = blockIdx.x / cl;
  const int64_t base = tile * block + rank * part;
  const int64_t groups = part / 4;
  const uint32_t bytes = static_cast<uint32_t>(part * 4);

  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&full, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(xs)), "l"(x + base), "r"(bytes),
           "r"(smem_u32(&full))
        : "memory");
  }
  mbar_wait(&full, 0);

  float amax = 0.f;
  for (int64_t g = threadIdx.x; g < groups; g += kClusterThreads)
    amax = nan_max(amax, abs_max4(xs[g]));
  amax = block_max(amax, partial);
  if (threadIdx.x == 0) cta_max = amax;
  cluster_arrive();                       // publishes cta_max
  cluster_wait();
  if (threadIdx.x < 32) {
    float m = static_cast<int>(threadIdx.x) < cl
                  ? load_from_rank(&cta_max, threadIdx.x) : 0.f;
    m = warp_max(m);
    if (threadIdx.x == 0) tile_max = m;
  }
  __syncthreads();
  const float scale = scale_of(tile_max);
  if (rank == 0 && threadIdx.x == 0) scales[tile] = scale;
  const float safe = scale > 0.f ? scale : 1.f;
  char4* q4 = reinterpret_cast<char4*>(q + base);
  for (int64_t g = threadIdx.x; g < groups; g += kClusterThreads)
    q4[g] = quantize4(xs[g], safe);
  // the second barrier keeps every CTA until the others have read its
  // partial; arriving at it before the stores measured slower
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ float unpack1(int8_t q, float s) {
  return __fmul_rn(static_cast<float>(q), s);
}

__global__ void __launch_bounds__(kUnpackThreads)
unpack_vec4(const int8_t* __restrict__ q, const float* __restrict__ scales,
            float* __restrict__ out, int64_t groups, int64_t block) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const float s = __ldg(scales + (g * 4) / block);
    const char4 c = reinterpret_cast<const char4*>(q)[g];
    reinterpret_cast<float4*>(out)[g] =
        make_float4(unpack1(c.x, s), unpack1(c.y, s), unpack1(c.z, s), unpack1(c.w, s));
  }
}

__global__ void __launch_bounds__(kUnpackThreads)
unpack_scalar(const int8_t* __restrict__ q, const float* __restrict__ scales,
              float* __restrict__ out, int64_t begin, int64_t n, int64_t block) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = begin + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = unpack1(q[i], __ldg(scales + i / block));
}

int grid_for(int64_t work) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t resident = static_cast<int64_t>(sms) * (2048 / kUnpackThreads);
  const int64_t need = (work + kUnpackThreads - 1) / kUnpackThreads;
  return static_cast<int>(need < resident ? (need > 0 ? need : 1) : resident);
}

}  // namespace

extern "C" {

// x f32 [n] -> q int8 [n], scales f32 [n / block]; n a multiple of block,
// one cluster of `cl` CTAs (1, 2, 4 or 8) per tile, each CTA a part of
// block / cl elements, a multiple of 4 (a bulk copy's 16 bytes), held in
// the shared memory a CTA takes without opting in to more; x 16-byte and
// q 4-byte aligned.  The wrapper picks cl (quantpack.py:cluster_size).
int quantpack_cluster(const float* x, int8_t* q, float* scales, int64_t n,
                      int64_t block, int64_t cl, void* stream) {
  if (cl < 1 || cl > kMaxCluster || (cl & (cl - 1)) != 0 || block % cl != 0 ||
      (block / cl) % 4 != 0 || !aligned(x, 16) || !aligned(q, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t part = block / cl;
  cudaFuncAttributes fa;
  const cudaError_t got = cudaFuncGetAttributes(&fa, pack_cluster);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (part * static_cast<int64_t>(sizeof(float)) > fa.maxDynamicSharedSizeBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = n / block;
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * cl));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(part) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pack_cluster, x, q, scales, block, part, static_cast<int>(cl));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x f32 [n] -> q int8 [n], scales f32 [n / block]; n a multiple of block.
// The two-pass kernel: any block, any alignment.
int quantpack_tiles(const float* x, int8_t* q, float* scales, int64_t n,
                    int64_t block, void* stream) {
  const int64_t tiles = n / block;
  if (tiles > 0) {
    const bool vec = block % 4 == 0 && aligned(x, 16) && aligned(q, 4);
    pack_tiles<<<static_cast<unsigned>(tiles), kPackThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, q, scales, block, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// q int8 [n], scales f32 [n / block] -> out f32 [n]; n a multiple of block.
int quantunpack(const int8_t* q, const float* scales, float* out, int64_t n,
                int64_t block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  int64_t done = 0;
  if (vec && n >= 4) {
    const int64_t groups = n / 4;
    unpack_vec4<<<grid_for(groups), kUnpackThreads, 0, s>>>(q, scales, out, groups, block);
    done = groups * 4;
  }
  if (done < n)
    unpack_scalar<<<grid_for(n - done), kUnpackThreads, 0, s>>>(q, scales, out, done, n, block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
