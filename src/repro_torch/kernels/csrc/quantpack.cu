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
// Built without --use_fast_math, so '/' and rintf stay IEEE.  Non-finite
// inputs are out of scope: fmaxf drops a NaN where the reference's max
// propagates it, and nothing special-cases them.
//
// Bound: memory.  quantpack reads 4 B and writes 1 B per element plus 4 B
// per tile; quantunpack reads 1 B and writes 4 B per element and reads 4 B
// per tile.  A handful of operations per element.
//
// Design.  quantpack runs one CUDA block per tile (64-bit indices): pass 1
// is a block-stride max of |x| with 16-byte loads, reduced by warp shuffles
// and shared memory; thread 0 forms the scale and writes it; pass 2 reads
// the tile again (from L2 when the tiles in flight fit in it) and stores
// four int8 values at a time.  A tile whose length or alignment does not
// allow the vector path runs the scalar loops.  A single-read design that
// holds the tile in registers (1,024 threads x 64 values) is later work.
// quantunpack is a grid-stride elementwise pass: 4-byte loads of four int8
// values, 16-byte stores, and a scalar tail.
//
// C interface for ctypes: every function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 512;
constexpr int kUnpackThreads = 256;

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int8_t quantize(float x, float safe) {
  const float r = rintf(__fdiv_rn(x, safe));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

__global__ void __launch_bounds__(kPackThreads)
pack_tiles(const float* __restrict__ x, int8_t* __restrict__ q,
           float* __restrict__ scales, int64_t block, bool vec) {
  __shared__ float partial[kPackThreads / 32];
  __shared__ float safe_s;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const float* xt = x + base;
  int8_t* qt = q + base;

  // pass 1: max |x| over the tile
  float amax = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xt);
    for (int64_t g = threadIdx.x; g < block / 4; g += blockDim.x) {
      const float4 v = x4[g];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int64_t i = threadIdx.x; i < block; i += blockDim.x)
      amax = fmaxf(amax, fabsf(xt[i]));
  }
  amax = warp_max(amax);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) partial[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < static_cast<int>(blockDim.x / 32) ? partial[lane] : 0.f;
    amax = warp_max(amax);
    if (lane == 0) {
      const float scale = __fmul_rn(amax, 1.0f / 127.0f);
      scales[blockIdx.x] = scale;
      safe_s = scale > 0.f ? scale : 1.f;
    }
  }
  __syncthreads();
  const float safe = safe_s;

  // pass 2: quantize
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xt);
    char4* q4 = reinterpret_cast<char4*>(qt);
    for (int64_t g = threadIdx.x; g < block / 4; g += blockDim.x) {
      const float4 v = x4[g];
      q4[g] = make_char4(quantize(v.x, safe), quantize(v.y, safe),
                         quantize(v.z, safe), quantize(v.w, safe));
    }
  } else {
    for (int64_t i = threadIdx.x; i < block; i += blockDim.x)
      qt[i] = quantize(xt[i], safe);
  }
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

// x f32 [n] -> q int8 [n], scales f32 [n / block]; n a multiple of block.
int quantpack(const float* x, int8_t* q, float* scales, int64_t n, int64_t block,
              void* stream) {
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
