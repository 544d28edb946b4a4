// Birkhoff-schedule gossip mixing: out[i, p] = sum_l gammas[l] * theta[perms[l, i], p].
//
// Replaces: repro/kernels/gossip_mix/gossip_schedule.py, gossip_schedule_pallas
// (the TPU kernel; its pallas_call is at gossip_schedule.py:92).
//
// Bound on an H100: device-memory bytes. Each output element costs L
// gathered reads and L multiply-adds, so the arithmetic intensity is
// about one FLOP per byte; the least time is
// (2 n P sizeof(T) + L n 4 + L 4) / 3.35 TB/s, reading theta once and
// writing out once.
//
// Design. The TPU kernel holds a whole (n, 2048) tile of theta in VMEM,
// so each element leaves HBM once however many atoms gather it. Here
// one block owns one output row i over one chunk of columns, and the
// row index is the fastest grid dimension: the n blocks of a column
// chunk are scheduled together, so the L gathers of that chunk find
// the source rows in the 50 MB L2 after their first read. Per block:
//  - the L source rows perms[l, i] and weights gammas[l] are staged in
//    shared memory (in tiles of kAtomTile, so any L works);
//  - each thread keeps its columns' sums in float32 registers and adds
//    the atoms in order l = 0..L-1 as a rounded multiply then a rounded
//    add (no FMA contraction), the same arithmetic as the plain version
//    (ref.py) and the reference, so f32 results agree bitwise with it;
//  - loads are 16 bytes a thread when P is a multiple of the vector
//    width and both buffers are 16-byte aligned, else coalesced scalar
//    loads; either path masks the ragged edge of P itself.
// Zero-weight padding atoms (ScheduleArrays) add exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAtomTile = 256;   // atoms staged in shared memory per pass
constexpr int kScalarUnroll = 4; // independent scalar loads per thread per atom
constexpr int kVecUnroll = 2;    // independent 16-byte loads per thread per atom
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T, widened to float32 registers.
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// Stage atoms [l0, l0 + m) of output row `row` in shared memory.
__device__ __forceinline__ void stage_atoms(const float* __restrict__ gammas,
                                            const int* __restrict__ perms, int n, int row,
                                            int l0, int m, int* s_src, float* s_g) {
  for (int j = threadIdx.x; j < m; j += kThreads) {
    s_src[j] = perms[(int64_t)(l0 + j) * n + row];
    s_g[j] = gammas[l0 + j];
  }
}

// Any P, any alignment: thread t reads columns c0 + t + k * kThreads, so
// every warp load is one contiguous run.
template <typename T>
__global__ void __launch_bounds__(kThreads)
schedule_scalar(const T* __restrict__ theta, const float* __restrict__ gammas,
                const int* __restrict__ perms, T* __restrict__ out, int n, int64_t P,
                int L) {
  __shared__ int s_src[kAtomTile];
  __shared__ float s_g[kAtomTile];
  const int row = blockIdx.x;
  const int64_t span = (int64_t)kThreads * kScalarUnroll;
  const int64_t n_chunks = (P + span - 1) / span;
  for (int64_t chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const int64_t c0 = chunk * span + threadIdx.x;
    float acc[kScalarUnroll];
#pragma unroll
    for (int k = 0; k < kScalarUnroll; ++k) acc[k] = 0.f;
    for (int l0 = 0; l0 < L; l0 += kAtomTile) {
      const int m = min(kAtomTile, L - l0);
      __syncthreads();  // the previous tile is consumed by every thread
      stage_atoms(gammas, perms, n, row, l0, m, s_src, s_g);
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const T* src = theta + (int64_t)s_src[j] * P;
        const float g = s_g[j];
#pragma unroll
        for (int k = 0; k < kScalarUnroll; ++k) {
          const int64_t c = c0 + (int64_t)k * kThreads;
          if (c < P) acc[k] = __fadd_rn(acc[k], __fmul_rn(g, to_f32(src[c])));
        }
      }
    }
    T* dst = out + (int64_t)row * P;
#pragma unroll
    for (int k = 0; k < kScalarUnroll; ++k) {
      const int64_t c = c0 + (int64_t)k * kThreads;
      if (c < P) dst[c] = from_f32<T>(acc[k]);
    }
  }
}

// P % Vec16<T>::N == 0 and 16-byte aligned buffers: thread t handles
// vectors v0 + t + k * kThreads of its row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
schedule_vec(const T* __restrict__ theta, const float* __restrict__ gammas,
             const int* __restrict__ perms, T* __restrict__ out, int n, int64_t P, int L) {
  constexpr int N = Vec16<T>::N;
  __shared__ int s_src[kAtomTile];
  __shared__ float s_g[kAtomTile];
  const int row = blockIdx.x;
  const int64_t n_vec = P / N;
  const int64_t span = (int64_t)kThreads * kVecUnroll;
  const int64_t n_chunks = (n_vec + span - 1) / span;
  for (int64_t chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const int64_t v0 = chunk * span + threadIdx.x;
    float acc[kVecUnroll][N];
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[k][e] = 0.f;
    for (int l0 = 0; l0 < L; l0 += kAtomTile) {
      const int m = min(kAtomTile, L - l0);
      __syncthreads();
      stage_atoms(gammas, perms, n, row, l0, m, s_src, s_g);
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const T* src = theta + (int64_t)s_src[j] * P;
        const float g = s_g[j];
#pragma unroll
        for (int k = 0; k < kVecUnroll; ++k) {
          const int64_t v = v0 + (int64_t)k * kThreads;
          if (v < n_vec) {
            float x[N];
            Vec16<T>::load(src + v * N, x);
#pragma unroll
            for (int e = 0; e < N; ++e) acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(g, x[e]));
          }
        }
      }
    }
    T* dst = out + (int64_t)row * P;
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k) {
      const int64_t v = v0 + (int64_t)k * kThreads;
      if (v < n_vec) Vec16<T>::store(dst + v * N, acc[k]);
    }
  }
}

template <typename T>
int launch(const void* theta, const void* gammas, const void* perms, void* out, int n,
           int64_t P, int L, int vectorized, void* stream) {
  const int64_t span = vectorized ? (int64_t)kThreads * kVecUnroll * Vec16<T>::N
                                  : (int64_t)kThreads * kScalarUnroll;
  const int64_t n_chunks = (P + span - 1) / span;
  const dim3 grid((unsigned)n, (unsigned)(n_chunks < kMaxGridY ? n_chunks : kMaxGridY));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* th = static_cast<const T*>(theta);
  const float* g = static_cast<const float*>(gammas);
  const int* pm = static_cast<const int*>(perms);
  T* o = static_cast<T*>(out);
  if (vectorized) {
    schedule_vec<T><<<grid, kThreads, 0, s>>>(th, g, pm, o, n, P, L);
  } else {
    schedule_scalar<T><<<grid, kThreads, 0, s>>>(th, g, pm, o, n, P, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// theta, out: (n, P) row-major; gammas: (L,) float32; perms: (L, n) int32
// with every entry in [0, n). Returns cudaGetLastError() after the launch.
extern "C" int gossip_schedule_f32(const void* theta, const void* gammas, const void* perms,
                                   void* out, int n, int64_t P, int L, int vectorized,
                                   void* stream) {
  return launch<float>(theta, gammas, perms, out, n, P, L, vectorized, stream);
}

extern "C" int gossip_schedule_bf16(const void* theta, const void* gammas, const void* perms,
                                    void* out, int n, int64_t P, int L, int vectorized,
                                    void* stream) {
  return launch<__nv_bfloat16>(theta, gammas, perms, out, n, P, L, vectorized, stream);
}
