// Dense gossip mixing: out = W @ theta, W (n, n), theta and out (n, P).
//
// Replaces: repro/kernels/gossip_mix/gossip_mix.py, gossip_mix_pallas
// (the TPU kernel; its pallas_call is at gossip_mix.py:49).
//
// Bound on an H100: the larger of the bytes, (2 n P + n^2) sizeof(T) at
// 3.35 TB/s, and the operations, 2 n^2 P. At the simulator's node counts
// (n = 100 .. 512) the operations dominate: the product runs in full
// float32 on the CUDA cores (67 TFLOP/s on the SXM part), not TF32,
// because the parity tolerance against the float32 reference is 1e-5.
//
// Design. A tiled SGEMM in shared memory. The TPU kernel holds W whole
// in VMEM and streams (n, 2048) tiles of theta through the MXU; here a
// block of 256 threads computes one (kBM x kBN) output tile, looping
// over the shared dimension in kBK steps: the W[kBM, kBK] tile (stored
// transposed) and the theta[kBK, kBN] tile are staged in shared memory,
// widened to float32, and each thread keeps a (kTM x kTN) register tile
// of sums (fmaf, float32). Thread (ty, tx) owns rows ty*kTM + i and
// columns tx + 16*j, so its shared-memory reads broadcast or hit
// distinct banks and its stores are coalesced. n and P are masked at
// every edge (zeros are staged past them), so any n and any P work;
// the TPU kernel's layout assumed n <= 64.
//
// W arrives in theta's dtype: ops.py casts it first, as the reference's
// ops.py does, so a bf16 theta mixes with a bf16-quantized W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 8;
constexpr int kThreads = 256;  // (kBM / kTM) x (kBN / kTN) = 16 x 16
static_assert((kBM / kTM) * (kBN / kTN) == kThreads, "thread tile mismatch");
static_assert(kBN / kTN == 16, "column stride below assumes 16 threads per row");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const T* __restrict__ W, const T* __restrict__ theta, T* __restrict__ out,
                  int n, int64_t P) {
  __shared__ float Ws[kBK][kBM + 4];  // W tile, transposed: Ws[k][m]
  __shared__ float Xs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int64_t p0 = (int64_t)blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    // W[m0 : m0 + kBM, k0 : k0 + kBK]: consecutive threads read
    // consecutive k of one row of W.
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int m = e / kBK;
      const int k = e % kBK;
      const int gm = m0 + m;
      const int gk = k0 + k;
      Ws[k][m] = (gm < n && gk < n) ? to_f32(W[(int64_t)gm * n + gk]) : 0.f;
    }
    // theta[k0 : k0 + kBK, p0 : p0 + kBN]: consecutive threads read
    // consecutive columns of one row of theta.
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int k = e / kBN;
      const int c = e % kBN;
      const int gk = k0 + k;
      const int64_t gp = p0 + c;
      Xs[k][c] = (gk < n && gp < P) ? to_f32(theta[(int64_t)gk * P + gp]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM];
      float b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = Ws[k][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= n) continue;
    T* dst = out + (int64_t)gm * P;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gp = p0 + tx + 16 * j;
      if (gp < P) dst[gp] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* W, const void* theta, void* out, int n, int64_t P, void* stream) {
  const int64_t col_tiles = (P + kBN - 1) / kBN;
  const dim3 grid((unsigned)col_tiles, (unsigned)((n + kBM - 1) / kBM));
  gossip_mix_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<const T*>(theta), static_cast<T*>(out), n, P);
  return (int)cudaGetLastError();
}

}  // namespace

// W: (n, n) and theta, out: (n, P), all row-major in one dtype. P must
// be below 2^31 * kBN (the grid's x limit). Returns cudaGetLastError().
extern "C" int gossip_mix_f32(const void* W, const void* theta, void* out, int n, int64_t P,
                              void* stream) {
  return launch<float>(W, theta, out, n, P, stream);
}

extern "C" int gossip_mix_bf16(const void* W, const void* theta, void* out, int n, int64_t P,
                               void* stream) {
  return launch<__nv_bfloat16>(W, theta, out, n, P, stream);
}
