// Flash attention forward: causal (optionally), sliding-window, tanh
// softcap, grouped-query (GQA / MQA) online-softmax attention.
//
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / Hkv)]
//   s_ij = cap * tanh((q_i . k_j) D^-0.5 / cap)   (no tanh when cap = 0)
//   kept: j <= i (causal), j > i - window (window > 0), j < S
//
// q, out: (B, S, H, D); k, v: (B, S, Hkv, D); all row-major, one dtype
// (float32 or bfloat16); D in {32, 64, 128, 256}. Two kernels, picked by
// dtype at the C entry points below:
//   - bfloat16: the tensor-core kernel of flash_attention_wgmma.cuh
//     (a TMA producer warpgroup, wgmma bf16 products, float32 sums and
//     softmax);
//   - float32: the CUDA-core kernel of this file, full float32 FMA (TF32
//     would miss the reference's 2e-3 float32 tolerance).
//
// Replaces: repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas (the TPU kernel; its pallas_call is at :153).
//
// Bound on an H100: the operations. 4 D flops per kept (q, k) pair and
// head (2 D for q.k, 2 D for p.v): for recurrentgemma-2b's layer
// (B 2, S 4096, H 10, D 256, window 2048) that is ~1.29e11 flops,
// ~0.13 ms at the 989 TFLOP/s bf16 tensor-core peak, ~1.9 ms at the
// 67 TFLOP/s float32 CUDA-core peak, against ~60 MB of bytes (~0.02 ms).
//
// Design of the float32 kernel. One block of 256 threads per (64-query
// tile, b * H + h); the
// latest (heaviest, under the causal mask) q tiles are launched first.
// The q tile is converted to float32 once into shared memory. A loop
// over 64-row kv tiles, BOUNDED to the tiles that hold at least one
// kept key for some query of the tile (the Pallas grid visits every kv
// tile and predicates the compute; here the causal and window bounds
// set the loop's range), stages k and v in shared memory as float32 and
// keeps the online-softmax state (m, l, acc) in registers:
//   - S = Q K^T: thread (ty, tx) computes rows 4 ty + i and columns
//     tx + 16 j (i, j < 4) as a 4 x 4 register tile, reading float4s
//     along D. Rows of the q and k tiles are padded to D + 4 floats, so
//     the eight threads of a quarter warp read k rows that start four
//     banks apart: no bank conflicts.
//   - scale, softcap, then the mask; row max and row sum are reduced
//     over the 16 threads of a row group with shuffles (a row group is
//     half a warp). Masked entries contribute exactly 0 (p is zeroed,
//     not exp(-2e9 - m)), so a tile with no kept key for a row leaves
//     that row's state as it was, and m starts at -2e9, so a row whose
//     first visited tiles hold no kept key never meets inf - inf.
//   - P goes to shared memory, and acc (4 rows x D / 16 columns per
//     thread, columns tx + 16 c) += P V.
// At the end out = acc / l; a row with l = 0 gives 0 (never the case
// for a real query: j = i is always kept). Ragged q and kv edges are
// masked here: rows past S load zeros and store nothing, keys past S
// load zeros and are masked. GQA is an index: query head h reads kv
// head h / (H / Hkv); k and v are never expanded.
//
// Shared memory: (2 * 64 * (D + 4) + 64 * D + 64 * 65) * 4 bytes, 210 KB
// at D = 256 (one block per SM), above the 48 KB static limit, so the
// launch raises the kernel's dynamic shared-memory limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr float kNegInf = -2.0e9f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ * (D + 4) + kBKV * (D + 4) + kBKV * D + kBQ * (kBKV + 1)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S, int H, int Hkv, int causal, int window,
                 float softcap, float scale) {
  constexpr int LD = D + 4;       // padded row stride of the q and k tiles
  constexpr int LP = kBKV + 1;    // padded row stride of the P tile
  constexpr int kCols = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;      // [kBKV][LD]
  float* Vs = Ks + kBKV * LD;     // [kBKV][D]
  float* Ps = Vs + kBKV * D;      // [kBQ][LP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * D;     // between positions of q and out
  const int64_t kv_stride = (int64_t)Hkv * D;  // between positions of k and v
  const float* qb = q + (int64_t)b * S * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * D;
  float* ob = out + (int64_t)b * S * q_stride + (int64_t)h * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int s = q0 + r;
    Qs[r * LD + c] = s < S ? qb[s * q_stride + c] : 0.f;
  }

  // kv tiles holding a kept key for some query of [q0, q_last]
  const int q_last = min(q0 + kBQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = k_lo / kBKV; t <= k_hi / kBKV; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    for (int e = tid; e < kBKV * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int s = k0 + r;
      const bool in = s < S;
      Ks[r * LD + c] = in ? kb[s * kv_stride + c] : 0.f;
      Vs[r * D + c] = in ? vb[s * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i].x, ka[j].x, sc[i][j]);
          sc[i][j] = fmaf(qa[i].y, ka[j].y, sc[i][j]);
          sc[i][j] = fmaf(qa[i].z, ka[j].z, sc[i][j]);
          sc[i][j] = fmaf(qa[i].w, ka[j].w, sc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool keep[4];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        keep[j] = kpos < S && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        sc[i][j] = s;
        if (keep[j]) rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv_l = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) ob[s * q_stride + tx + 16 * c] = acc[i][c] * inv_l;
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
             int Hkv, int causal, int window, float softcap, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, H, Hkv, causal, window, softcap,
      scale > 0.f ? scale : (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int Hkv,
           int D, int causal, int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, st);
    case 64: return launch_d<64>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, st);
    case 128: return launch_d<128>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, st);
    case 256: return launch_d<256>(q, k, v, out, B, S, H, Hkv, causal, window, softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, S, H, D); k, v: (B, S, Hkv, D); row-major, one dtype. Hkv
// divides H, D in {32, 64, 128, 256}, B * H <= 65535. window <= 0 means
// no window; softcap <= 0 means no softcap; the logits are scaled by
// `scale`, or by D^-0.5 where scale <= 0. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for another D).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int S, int H, int Hkv, int D, int causal, int window,
                                   float softcap, float scale, void* stream) {
  return launch(q, k, v, out, B, S, H, Hkv, D, causal, window, softcap, scale, stream);
}

// The tensor-core kernel: q, k, v and out also 16-byte aligned (TMA
// reads q, k and v). Returns cudaErrorNotSupported if the driver has no
// tensor-map encoder.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int S, int H, int Hkv, int D, int causal, int window,
                                    float softcap, float scale, void* stream) {
  return flash_wgmma::launch(q, k, v, out, nullptr, nullptr, B, S, H, Hkv, D, causal, window,
                             softcap, scale, stream);
}

// The same forward under autograd: it also writes the backward's inputs,
// o32 (B, S, H, D) float32 and lse (B, H, S_pad) float32, S_pad = S
// rounded up to a multiple of 128.
extern "C" int flash_attention_bf16_save(const void* q, const void* k, const void* v, void* out,
                                         void* o32, void* lse, int B, int S, int H, int Hkv,
                                         int D, int causal, int window, float softcap,
                                         float scale, void* stream) {
  return flash_wgmma::launch(q, k, v, out, o32, lse, B, S, H, Hkv, D, causal, window, softcap,
                             scale, stream);
}
