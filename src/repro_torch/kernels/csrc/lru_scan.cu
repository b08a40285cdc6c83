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
// Design.  One thread per (batch, channel) walks time; neighbouring threads
// take neighbouring channels, so each load and store of a warp is one
// coalesced 128-byte line.  The time loop is unrolled by kUnroll: the
// loads of a whole chunk are issued before its dependent chain of
// multiply-adds, so each thread keeps 2 * kUnroll loads in flight to hide
// the memory latency the serial chain would otherwise expose.  At the
// path's shape B * C = 8,192 threads is less than one wave of 132 SMs; a
// time-chunked two-pass scan that spreads S over more threads is later
// work.
//
// C interface for ctypes: returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" int lru_scan(const void* a, const void* b, const void* h0,
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
