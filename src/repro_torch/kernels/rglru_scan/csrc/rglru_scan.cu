// RG-LRU linear scan: h_t = a_t * h_{t-1} + b_t along S, h_{-1} = 0.
//
// a, b, h: (B, S, D), row-major, one dtype (float32 or bfloat16),
// float32 arithmetic inside.
//
// Replaces: repro/kernels/rglru_scan/rglru_scan.py, rglru_scan_pallas
// (the TPU kernel; its pallas_call is at :73).
//
// Bound on an H100: the bytes. Each element of a and b is read once and
// h written once, 3 B S D sizeof(T) bytes at 3.35 TB/s (recurrentgemma-2b,
// B 2, S 4096, D 2560, float32: 252 MB, ~0.075 ms); the 3 flops an
// element are nothing beside them.
//
// Design. The TPU kernel carries the state across time blocks because
// its grid runs in order; here blocks run in no order, so the time axis
// is split INSIDE a block, in two passes over it (a chunked scan):
//   block = 32 feature lanes (one warp wide, so a warp's loads of one
//   time step are 128 contiguous bytes) x 16 time chunks; grid =
//   (ceil(D / 32), B).
//   1. thread (lane, c) composes chunk c of its feature from h = 0:
//      A_c = prod a_t, H_c = the chunk's end state;
//   2. one warp walks the 16 chunks and turns (A_c, H_c) into each
//      chunk's incoming state;
//   3. every thread rescans its chunk from that state and writes h.
// a and b are read twice (pass 3 mostly misses L2 at the full width:
// 168 MB of a and b against a 50 MB L2), so the traffic is 5 B S D
// sizeof(T), not 3; in exchange B * D / 32 * 16 warps are in flight, not
// the B * D / 32 of one thread per feature walking all of S (160 warps at
// recurrentgemma-2b's width, far too few to cover the memory latency).
// Ragged S (the chunks are ceil(S / 16) long; empty ones compose to the
// identity) and ragged D (lanes past D load nothing and store nothing)
// are masked here: nothing is padded with a = 1, b = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kChunks = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kChunks)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h, int S,
                  int D) {
  __shared__ float A_s[kChunks][kLanes];  // pass 1: chunk products; pass 2: incoming states
  __shared__ float H_s[kChunks][kLanes];  // pass 1: chunk end states from h = 0
  const int lane = threadIdx.x;
  const int c = threadIdx.y;
  const int d = blockIdx.x * kLanes + lane;
  const int64_t base = (int64_t)blockIdx.y * S * D + d;
  const int len = (S + kChunks - 1) / kChunks;
  const int t0 = min(S, c * len);
  const int t1 = min(S, t0 + len);
  const bool active = d < D;

  float A = 1.f, hc = 0.f;
  if (active) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const float at = to_f32(a[base + (int64_t)t * D]);
      const float bt = to_f32(b[base + (int64_t)t * D]);
      hc = fmaf(at, hc, bt);
      A *= at;
    }
  }
  A_s[c][lane] = A;
  H_s[c][lane] = hc;
  __syncthreads();
  if (c == 0) {
    float carry = 0.f;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      const float Ac = A_s[cc][lane];
      A_s[cc][lane] = carry;
      carry = fmaf(Ac, carry, H_s[cc][lane]);
    }
  }
  __syncthreads();
  if (active) {
    hc = A_s[c][lane];
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const int64_t i = base + (int64_t)t * D;
      hc = fmaf(to_f32(a[i]), hc, to_f32(b[i]));
      h[i] = from_f32<T>(hc);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int D, void* stream) {
  const dim3 grid((unsigned)((D + kLanes - 1) / kLanes), (unsigned)B);
  const dim3 block(kLanes, kChunks);
  rglru_scan_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, D), row-major, one dtype; B <= 65535. Returns the
// launch's cudaError_t.
extern "C" int rglru_scan_f32(const void* a, const void* b, void* h, int B, int S, int D,
                              void* stream) {
  return launch<float>(a, b, h, B, S, D, stream);
}

extern "C" int rglru_scan_bf16(const void* a, const void* b, void* h, int B, int S, int D,
                               void* stream) {
  return launch<__nv_bfloat16>(a, b, h, B, S, D, stream);
}
