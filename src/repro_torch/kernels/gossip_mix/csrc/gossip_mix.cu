// Dense gossip mixing: out = W @ theta, W (n, n), theta and out (n, P).
//
// Replaces: repro/kernels/gossip_mix/gossip_mix.py, gossip_mix_pallas
// (the TPU kernel; its pallas_call is at gossip_mix.py:49).
//
// Bound on an H100: the larger of the bytes, (2 n P + n^2) sizeof(T) at
// 3.35 TB/s, and the operations, 2 n^2 P. At the simulator's node counts
// (n = 100 .. 512) in float32 on the CUDA cores (67 TFLOP/s) the
// operations dominate; on the tensor cores (3xTF32 below) the bytes do.
// The parity tolerance against the float32 reference is 1e-5, so plain
// TF32 (~1e-3) is out.
//
// Design. The TPU kernel holds W whole in VMEM and streams (n, 2048)
// tiles of theta through the MXU. Here a block owns strips of theta's
// columns and ALL n rows of the output, so each theta element is read
// from device memory once, and W is loaded once per block of a
// persistent grid (as many blocks as fit on the card, block b walking
// strips b, b + gridDim.x, ...). Three kernels, by dtype and n:
//   - float32, n <= 128: 3xTF32 on the tensor cores with wgmma
//     (mix_tf32x3_kernel, below): W's fragments in registers, 32-column
//     strips through a six-stage 16-byte cp.async ring, each strip's MMAs
//     overlapping the next strip's transpose and the last one's stores.
//   - otherwise, W resident in shared memory when the n8 x n8 W fits
//     beside two 64-column strips and n8 <= 192 (float32 n <= 176,
//     bfloat16 n <= 192; n8 = n rounded up to 8): full float32 FMA
//     (bfloat16 widened in registers), strip j + 1 streaming into a
//     two-strip cp.async ring while strip j is computed.
//   - larger n: K-tiled FMA, one block per (128 rows, 64-column strip);
//     W (128 x 32) and theta (32 x 64) chunks stream through the same
//     two-stage cp.async ring along the shared dimension.
// The two FMA kernels share a register tile: thread (rg, cg) owns 8 rows
// rg + i RG (RG row groups) and 4 columns 4 cg .. 4 cg + 3 (16 column
// groups), 32 float32 sums. A step of 4 along k reads 8 W vectors (4 k
// each, broadcast: a warp holds 2 row groups) and 4 theta vectors, 12
// shared loads for 128 FMAs. Rows of the W tile are padded to a stride
// of 16 mod 32 bytes, so the two row groups of a warp fall on different
// banks. The FMAs run in k order, one fmaf chain a sum.
// The FMA kernels copy with 16-byte cp.async where the row strides and
// pointers allow (P % 4 == 0 in float32), else 8 or 4 bytes; a bfloat16 theta or
// W with an odd row length is staged with 2-byte loads. The ragged n and
// P edges are zero-filled by the copies and masked at the stores.
//
// W arrives in theta's dtype: ops.py casts it first, as the reference's
// ops.py does, so a bf16 theta mixes with a bf16-quantized W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;   // columns of a strip
constexpr int kCG = 16;   // column groups (4 columns each)
constexpr int kTM = 8;    // rows per thread
constexpr int kBM = 128;  // rows of a K-tiled block
constexpr int kBK = 32;   // shared-dimension chunk of the K-tiled kernel
constexpr int kTiledThreads = (kBM / kTM) * kCG;  // 256
constexpr int kMaxResidentThreads = 384;           // n8 <= 192
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

// Shared row stride (elements) for rows of `cols` elements: rounded up
// to 32 bytes plus 16, so rows 1 apart start on different banks and
// every row start stays 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int padded_ld(int cols) {
  return (((cols * (int)sizeof(T) + 31) / 32) * 32 + 16) / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy a (rows x cols) tile, cols a multiple of vb / sizeof(T), from
// global (row stride ld_src, columns from col0) to shared (row stride
// ld_dst). Rows >= rows_valid and columns >= cols_valid are zero-filled.
// vb (bytes per copy) is 16, 8 or 4 (cp.async) or 2 (bfloat16 loads).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld_dst, const T* src, int64_t ld_src,
                                      int rows, int rows_valid, int64_t col0, int cols,
                                      int64_t cols_valid, int vb, int tid, int nthreads) {
  const int vec = vb / (int)sizeof(T);
  const int per_row = cols / vec;
  for (int e = tid; e < rows * per_row; e += nthreads) {
    const int r = e / per_row;
    const int c = (e % per_row) * vec;
    const bool valid = r < rows_valid && col0 + c < cols_valid;
    const T* s = valid ? src + (int64_t)r * ld_src + col0 + c : src;
    T* d = dst + r * ld_dst + c;
    const int n = valid ? vb : 0;  // src-size: 0 zero-fills without reading
    switch (vb) {
      case 16:
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(d)),
                     "l"(s), "r"(n)
                     : "memory");
        break;
      case 8:
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(d)),
                     "l"(s), "r"(n)
                     : "memory");
        break;
      case 4:
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(d)),
                     "l"(s), "r"(n)
                     : "memory");
        break;
      default:  // 2 bytes: a bfloat16 element
        *reinterpret_cast<uint16_t*>(d) = valid ? *reinterpret_cast<const uint16_t*>(s) : 0;
    }
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// four consecutive elements of shared memory as float32
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc[i][j] += sum_{k < kc} W[row i][k] X[k][col j], k in order. w points
// at the thread's first row (row stride w_row between its 8 rows), x at
// its first column (row stride kBN). kc is a multiple of 4.
template <typename T>
__device__ __forceinline__ void mac(float (&acc)[kTM][4], const T* w, int w_row, const T* x,
                                    int kc) {
#pragma unroll 2
  for (int k = 0; k < kc; k += 4) {
    float4 xv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = ld4(x + (k + j) * kBN);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float4 wv = ld4(w + i * w_row + k);
      float* a = acc[i];
      a[0] = fmaf(wv.x, xv[0].x, a[0]);
      a[1] = fmaf(wv.x, xv[0].y, a[1]);
      a[2] = fmaf(wv.x, xv[0].z, a[2]);
      a[3] = fmaf(wv.x, xv[0].w, a[3]);
      a[0] = fmaf(wv.y, xv[1].x, a[0]);
      a[1] = fmaf(wv.y, xv[1].y, a[1]);
      a[2] = fmaf(wv.y, xv[1].z, a[2]);
      a[3] = fmaf(wv.y, xv[1].w, a[3]);
      a[0] = fmaf(wv.z, xv[2].x, a[0]);
      a[1] = fmaf(wv.z, xv[2].y, a[1]);
      a[2] = fmaf(wv.z, xv[2].z, a[2]);
      a[3] = fmaf(wv.z, xv[2].w, a[3]);
      a[0] = fmaf(wv.w, xv[3].x, a[0]);
      a[1] = fmaf(wv.w, xv[3].y, a[1]);
      a[2] = fmaf(wv.w, xv[3].z, a[2]);
      a[3] = fmaf(wv.w, xv[3].w, a[3]);
    }
  }
}

// Four sums to out[0..3] (columns c0 .. c0 + 3 of a row), in vectors of
// vec elements (1, 2 or 4; vec divides P, so a vector is all in or out).
__device__ __forceinline__ void store4(float* out, const float (&a)[4], int64_t c0, int64_t P,
                                       int vec) {
  if (vec == 4) {
    if (c0 < P) *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
  } else if (vec == 2) {
    if (c0 < P) *reinterpret_cast<float2*>(out) = make_float2(a[0], a[1]);
    if (c0 + 2 < P) *reinterpret_cast<float2*>(out + 2) = make_float2(a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < P) out[j] = a[j];
  }
}
__device__ __forceinline__ void store4(bf16* out, const float (&a)[4], int64_t c0, int64_t P,
                                       int vec) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  if (vec == 4) {
    if (c0 < P) {
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out) = u;
    }
  } else if (vec == 2) {
    if (c0 < P) *reinterpret_cast<__nv_bfloat162*>(out) = lo;
    if (c0 + 2 < P) *reinterpret_cast<__nv_bfloat162*>(out + 2) = hi;
  } else {
    const bf16 v[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < P) out[j] = v[j];
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTM][4]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// W resident in shared memory; blockDim.x = (n8 / 8) * 16; persistent
// over the strips. Shared: W [n8][ldw], then two theta strips [n8][kBN].
template <typename T>
__global__ void __launch_bounds__(kMaxResidentThreads)
mix_resident_kernel(const T* __restrict__ W, const T* __restrict__ theta, T* __restrict__ out,
                    int n, int64_t P, int n8, int vb_w, int vb_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldw = padded_ld<T>(n8);
  T* Ws = reinterpret_cast<T*>(smem_raw);
  T* Xs = Ws + n8 * ldw;  // strip buffer b at Xs + b * n8 * kBN
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int RG = n8 / kTM;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  const int64_t n_strips = (P + kBN - 1) / kBN;
  const int vec_out = min(vb_x / (int)sizeof(T), 4);

  stage(Ws, ldw, W, n, n8, n, 0, n8, n, vb_w, tid, nthreads);
  int64_t s = blockIdx.x;
  stage(Xs, kBN, theta, P, n8, n, s * kBN, kBN, P, vb_x, tid, nthreads);
  cp_commit();
  if (s + gridDim.x < n_strips)
    stage(Xs + n8 * kBN, kBN, theta, P, n8, n, (s + gridDim.x) * kBN, kBN, P, vb_x, tid,
          nthreads);
  cp_commit();

  for (int j = 0; s < n_strips; ++j, s += gridDim.x) {
    T* buf = Xs + (j & 1) * n8 * kBN;
    cp_wait1();
    __syncthreads();
    float acc[kTM][4];
    zero(acc);
    mac(acc, Ws + rg * ldw, RG * ldw, buf + cg * 4, n8);
    const int64_t c0 = s * kBN + cg * 4;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = rg + i * RG;
      if (m < n) store4(out + (int64_t)m * P + c0, acc[i], c0, P, vec_out);
    }
    __syncthreads();  // every thread is done with buf before it is refilled
    if (s + 2 * gridDim.x < n_strips)
      stage(buf, kBN, theta, P, n8, n, (s + 2 * gridDim.x) * kBN, kBN, P, vb_x, tid, nthreads);
    cp_commit();
  }
}

// One block per (kBM rows, strip); the shared dimension in kBK chunks.
// Shared: two W chunks [kBM][ldw], then two theta chunks [kBK][kBN].
template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
mix_tiled_kernel(const T* __restrict__ W, const T* __restrict__ theta, T* __restrict__ out,
                 int n, int64_t P, int vb_w, int vb_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldw = padded_ld<T>(kBK);
  constexpr int RG = kBM / kTM;
  T* Ws = reinterpret_cast<T*>(smem_raw);  // chunk b at Ws + b * kBM * ldw
  T* Xs = Ws + 2 * kBM * ldw;              // chunk b at Xs + b * kBK * kBN
  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  const int m0 = blockIdx.y * kBM;
  const int64_t col0 = (int64_t)blockIdx.x * kBN;
  const int nk = (n + kBK - 1) / kBK;
  const int vec_out = min(vb_x / (int)sizeof(T), 4);
  const T* Wb = W + (int64_t)m0 * n;

  stage(Ws, ldw, Wb, n, kBM, n - m0, 0, kBK, n, vb_w, tid, kTiledThreads);
  stage(Xs, kBN, theta, P, kBK, n, col0, kBN, P, vb_x, tid, kTiledThreads);
  cp_commit();
  float acc[kTM][4];
  zero(acc);
  for (int kc = 0; kc < nk; ++kc) {
    const int b = kc & 1;
    if (kc + 1 < nk) {
      const int k1 = (kc + 1) * kBK;
      stage(Ws + (b ^ 1) * kBM * ldw, ldw, Wb, n, kBM, n - m0, k1, kBK, n, vb_w, tid,
            kTiledThreads);
      stage(Xs + (b ^ 1) * kBK * kBN, kBN, theta + (int64_t)k1 * P, P, kBK, n - k1, col0, kBN, P,
            vb_x, tid, kTiledThreads);
    }
    cp_commit();
    cp_wait1();
    __syncthreads();
    mac(acc, Ws + b * kBM * ldw + rg * ldw, RG * ldw, Xs + b * kBK * kBN + cg * 4, kBK);
    __syncthreads();
  }
  const int64_t c0 = col0 + cg * 4;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + rg + i * RG;
    if (m < n) store4(out + (int64_t)m * P + c0, acc[i], c0, P, vec_out);
  }
}

// ---------------------------------------------------------------------------
// float32 with n <= 128 on the tensor cores: 3xTF32 on wgmma (m64n32k8).
// Each float32 x is split as big = tf32(x) (rounded) and small = x - big
// (exact; the tensor core reads its top 19 bits); the sum takes
// Wb.xb + Ws.xb + Wb.xs, dropping Ws.xs: every product keeps ~21 of
// float32's 24 bits, inside the 1e-5 parity (plain TF32 keeps 11).
// Two warpgroups own output rows 0-63 and 64-127; warp w's W fragments
// (rows 16 w .. 16 w + 15, all of K, split) live in registers for the
// whole kernel, loaded once from device memory. theta streams in strips
// of 32 columns (n8 rows) through a six-stage ring of 16-byte cp.async
// (the strided column strips need many bytes in flight to keep the
// memory busy); the grid is persistent. wgmma reads a tf32 B from shared
// memory only K-major, so each strip is transposed and split into two
// K-major, 128-byte-swizzled tiles (big, small). The MMAs run asynchronously:
// while strip j's MMAs fly, the block transposes strip j + 1 into the
// other pair of tiles, then stores strip j while strip j + 1's MMAs fly
// (two accumulators, alternating).
// ---------------------------------------------------------------------------

constexpr int kMmaBN = 32;          // columns of a strip
constexpr int kMmaLD = kMmaBN + 8;  // shared row stride of the ring (floats)
constexpr int kMmaStages = 6;       // 5 strips in flight: ~83 KB a block at n = 100
constexpr int kMmaMaxN = 128;
constexpr int kMmaThreads = 256;           // two warpgroups
constexpr int kBTile = 4 * kMmaBN * 128;  // bytes of one split part: 4 K blocks of [32][32 tf32]

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// K-major, 128-byte-swizzled shared-memory matrix descriptor (LBO unused,
// SBO = 8 rows of 128 bytes)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 32, f32) = a (64 x 8, tf32, registers) * b (8 x 32, tf32, shared)
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// keeps the compiler from touching accumulator registers wgmma owns
__device__ __forceinline__ void fence_operands(float (&acc)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

size_t tf32x3_smem(int n8) {
  return (size_t)kMmaStages * n8 * kMmaLD * sizeof(float) + 4 * kBTile + 1024;
}

// The per-strip steps of mix_tf32x3_kernel for K8 = n8 / 8 k8 steps (a
// compile-time count, so the MMAs issue back to back).
template <int K8>
struct Tf32x3 {
  const float* theta;
  float* out;
  int n, n8;
  int64_t P;
  int vb_x;
  float* Xs;                  // ring stage s at Xs + s * n8 * kMmaLD
  unsigned char* B;           // split tiles of strip parity q at B + 2 q kBTile (big, small)
  uint32_t B_s;               // the same, as a shared address
  int tid, r0;                // r0: this thread's first output row (r0 + 8 the second)

  // Row r of the strip, as the nine 16-byte chunks from its first column's
  // address rounded down to 16 bytes: 16-byte copies whatever P and the
  // alignment (the row's data then starts shift(r) floats into the slot
  // row). A chunk past the row's end is cut there and zero-filled, so
  // nothing past theta is read; the bytes before a misaligned row start
  // lie in the row before it or, for row 0, in the allocation theta is a
  // view of (allocations are 256-byte aligned).
  __device__ void load(int64_t strip, int slot) const {
    const uint32_t dst = smem_u32(Xs + slot * n8 * kMmaLD);
    for (int e = tid; e < n8 * 9; e += kMmaThreads) {
      const int r = e / 9, m = e % 9;
      const uintptr_t row = reinterpret_cast<uintptr_t>(theta + (int64_t)r * P);
      const uintptr_t chunk = ((row + strip * kMmaBN * 4) & ~uintptr_t(15)) + 16 * m;
      const uintptr_t end = row + P * 4;
      const int bytes = r >= n || chunk >= end ? 0 : end - chunk < 16 ? (int)(end - chunk) : 16;
      const uintptr_t src = bytes ? chunk : reinterpret_cast<uintptr_t>(theta);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst + r * kMmaLD * 4 + 16 * m),
                   "l"(src), "r"(bytes)
                   : "memory");
    }
  }

  // where row r's data starts in its slot row, in floats
  __device__ int shift(int r) const {
    return (int)((reinterpret_cast<uintptr_t>(theta + (int64_t)r * P) & 15) >> 2);
  }

  // column c, rows 4 q .. 4 q + 3 of ring slot `slot` become the 16-byte
  // chunk q % 8 (swizzled with c % 8) of row c in K block q / 8 of the
  // tiles of parity `par`
  __device__ void transpose(int slot, int par) const {
    const float* X = Xs + slot * n8 * kMmaLD;
    unsigned char* big = B + 2 * par * kBTile;
    for (int e = tid; e < kMmaBN * 2 * K8; e += kMmaThreads) {
      const int c = e % kMmaBN, q = e / kMmaBN;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = X[(4 * q + i) * kMmaLD + shift(4 * q + i) + c];
        hi[i] = tf32(x);
        lo[i] = __float_as_uint(x - __uint_as_float(hi[i]));
      }
      const int off = (q / 8) * kMmaBN * 128 + c * 128 + (((q % 8) ^ (c % 8)) << 4);
      *reinterpret_cast<uint4*>(big + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(big + kBTile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }

  // acc = Wb.xb + Ws.xb + Wb.xs over the tiles of parity `par`, issued
  // asynchronously (one commit group)
  __device__ void mma(float (&acc)[16], const uint32_t (&wb)[K8][4], const uint32_t (&ws)[K8][4],
                      int par) const {
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < K8; ++kk) {
      const uint32_t off = 2 * par * kBTile + (kk / 4) * kMmaBN * 128 + (kk % 4) * 32;
      const uint64_t db = kmajor_desc(B_s + off);
      const uint64_t ds = kmajor_desc(B_s + kBTile + off);
      wgmma_tf32(acc, wb[kk], db, kk > 0);
      wgmma_tf32(acc, ws[kk], db, 1);
      wgmma_tf32(acc, wb[kk], ds, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // accumulator: acc[4 i + 0, 1] at (r0, 8 i + 2 t + {0, 1}), acc[4 i + 2, 3] at r0 + 8
  __device__ void store(const float (&acc)[16], int64_t strip) const {
    const int t = tid % 4;
    const bool pairs = vb_x >= 8;  // P even and out 8-byte aligned: float2 stores
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t c = strip * kMmaBN + 8 * i + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= n) continue;
        float* dst = out + (int64_t)r * P + c;
        if (pairs) {
          if (c < P) *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        } else {
          if (c < P) dst[0] = acc[4 * i + 2 * h];
          if (c + 1 < P) dst[1] = acc[4 * i + 2 * h + 1];
        }
      }
    }
  }

  // strip j's MMAs (into `cur`, parity j % 2) are in flight; prepare strip
  // j + 1 (if `next` < n_strips) and start its MMAs into `nxt`, then store j
  __device__ void step(float (&cur)[16], float (&nxt)[16], const uint32_t (&wb)[K8][4],
                       const uint32_t (&ws)[K8][4], int j, int64_t strip, int64_t next,
                       int64_t G, int64_t n_strips) const {
    const bool has_next = next < n_strips;  // block-uniform
    if (has_next) {
      cp_wait<kMmaStages - 2>();  // strip j + 1 has landed
      __syncthreads();
      const int64_t ahead = next + (kMmaStages - 1) * G;
      if (ahead < n_strips) load(ahead, (j + kMmaStages) % kMmaStages);
      cp_commit();
      transpose((j + 1) % kMmaStages, (j + 1) % 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(cur);
    __syncthreads();  // strip j + 1's tiles are written; strip j's MMAs are done
    if (has_next) mma(nxt, wb, ws, (j + 1) % 2);
    store(cur, strip);
  }
};

// Shared: kMmaStages ring strips [n8][kMmaLD], then (1024-aligned) two
// pairs of split tiles (big, small), one per strip parity. Both
// warpgroups run every MMA (rows past n multiply zeros and are not
// stored): a warpgroup-dependent branch around wgmma serializes it.
template <int K8>
__global__ void __launch_bounds__(kMmaThreads, 1)
mix_tf32x3_kernel(const float* __restrict__ W, const float* __restrict__ theta,
                  float* __restrict__ out, int n, int64_t P, int vb_x) {
  using K = Tf32x3<K8>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K k;
  k.theta = theta;
  k.out = out;
  k.n = n;
  k.n8 = (n + 7) / 8 * 8;
  k.P = P;
  k.vb_x = vb_x;
  k.Xs = reinterpret_cast<float*>(smem_raw);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t b_off = ((raw + kMmaStages * k.n8 * kMmaLD * 4 + 1023) & ~1023u) - raw;
  k.B = smem_raw + b_off;
  k.B_s = raw + b_off;
  k.tid = threadIdx.x;
  k.r0 = (k.tid / 32) * 16 + (k.tid % 32) / 4;

  // A fragments: a0 (r0, t), a1 (r0 + 8, t), a2 (r0, t + 4), a3 (r0 + 8, t + 4)
  // of each k8 step, zero past n
  uint32_t wb[K8][4], ws[K8][4];
  const int t = k.tid % 4;
#pragma unroll
  for (int kk = 0; kk < K8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = k.r0 + ((e & 1) ? 8 : 0);
      const int c = 8 * kk + t + ((e & 2) ? 4 : 0);
      const float w = (r < n && c < n) ? W[(int64_t)r * n + c] : 0.f;
      wb[kk][e] = tf32(w);
      ws[kk][e] = tf32(w - __uint_as_float(wb[kk][e]));
    }
  }

  const int64_t n_strips = (P + kMmaBN - 1) / kMmaBN;
  const int64_t G = gridDim.x;
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    const int64_t strip = blockIdx.x + s * G;
    if (strip < n_strips) k.load(strip, s);
    cp_commit();
  }
  // strip 0 of this block: land, transpose, start its MMAs
  cp_wait<kMmaStages - 2>();
  __syncthreads();
  if (blockIdx.x + (kMmaStages - 1) * G < n_strips) k.load(blockIdx.x + (kMmaStages - 1) * G, kMmaStages - 1);
  cp_commit();
  k.transpose(0, 0);
  __syncthreads();
  float acc0[16], acc1[16];
  k.mma(acc0, wb, ws, 0);
  int j = 0;
  for (int64_t strip = blockIdx.x; strip < n_strips; strip += 2 * G, j += 2) {
    k.step(acc0, acc1, wb, ws, j, strip, strip + G, G, n_strips);
    if (strip + G >= n_strips) break;
    k.step(acc1, acc0, wb, ws, j + 1, strip + G, strip + 2 * G, G, n_strips);
  }
}

// bytes per copy: the widest of 16, 8, 4 that divides the row length's
// bytes and the pointers' addresses; 2 (bfloat16 element copies) if none.
int copy_bytes(int64_t row_bytes, const void* a, const void* b) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  for (int vb = 16; vb >= 4; vb /= 2)
    if (row_bytes % vb == 0 && addr % vb == 0) return vb;
  return 2;
}

// shared bytes of the W-resident FMA kernel, and whether it takes n8
template <typename T>
size_t resident_smem(int n8) {
  return ((size_t)n8 * padded_ld<T>(n8) + 2 * (size_t)n8 * kBN) * sizeof(T);
}
template <typename T>
bool fits_resident(int n8, int max_smem) {
  return resident_smem<T>(n8) <= (size_t)max_smem && n8 / kTM * kCG <= kMaxResidentThreads;
}

enum Design { kTf32x3 = 0, kResident = 1, kTiled = 2 };

// mix_tf32x3_kernel<K8> for K8 = n8 / 8 = 1 .. 16
const void* const tf32x3_kernels[] = {
    (const void*)mix_tf32x3_kernel<1>,  (const void*)mix_tf32x3_kernel<2>,
    (const void*)mix_tf32x3_kernel<3>,  (const void*)mix_tf32x3_kernel<4>,
    (const void*)mix_tf32x3_kernel<5>,  (const void*)mix_tf32x3_kernel<6>,
    (const void*)mix_tf32x3_kernel<7>,  (const void*)mix_tf32x3_kernel<8>,
    (const void*)mix_tf32x3_kernel<9>,  (const void*)mix_tf32x3_kernel<10>,
    (const void*)mix_tf32x3_kernel<11>, (const void*)mix_tf32x3_kernel<12>,
    (const void*)mix_tf32x3_kernel<13>, (const void*)mix_tf32x3_kernel<14>,
    (const void*)mix_tf32x3_kernel<15>, (const void*)mix_tf32x3_kernel<16>};

// the kernel gossip_mix runs for n nodes and element size es
Design design(int n, int es, int max_smem) {
  const int n8 = (n + 7) / 8 * 8;
  if (es == 4 && n <= kMmaMaxN) return kTf32x3;
  const bool fits = es == 2 ? fits_resident<bf16>(n8, max_smem) : fits_resident<float>(n8, max_smem);
  return fits ? kResident : kTiled;
}

struct DeviceInfo {
  int sms = 0;
  int max_smem = 0;  // opt-in shared memory per block
  // the n8 of the last occupancy query of each persistent kernel, and its answer
  // (slots: the 3xTF32 kernel, the resident kernel in float32, in bfloat16)
  int n8[3] = {0, 0, 0};
  int blocks[3] = {0, 0, 0};
};

int device_info(DeviceInfo** out) {
  static DeviceInfo info[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    int sms = 0, max_smem = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess)
      return (int)err;
    for (const void* k : tf32x3_kernels)
      if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem)) !=
          cudaSuccess)
        return (int)err;
    const void* kernels[] = {(const void*)mix_resident_kernel<float>,
                             (const void*)mix_resident_kernel<bf16>,
                             (const void*)mix_tiled_kernel<float>,
                             (const void*)mix_tiled_kernel<bf16>};
    for (const void* k : kernels)
      if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem)) !=
          cudaSuccess)
        return (int)err;
    d.max_smem = max_smem;
    d.sms = sms;
  }
  *out = &d;
  return 0;
}

// persistent grid: blocks that fit on the card at once, at most `work`
int persistent_grid(DeviceInfo& d, int slot, const void* kernel, int threads, size_t smem,
                    int n8, int64_t work, unsigned* grid) {
  if (d.n8[slot] != n8) {
    int blocks = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    d.blocks[slot] = blocks > 0 ? blocks : 1;
    d.n8[slot] = n8;
  }
  const int64_t full = (int64_t)d.blocks[slot] * d.sms;
  *grid = (unsigned)(work < full ? work : full);
  return 0;
}

template <typename T>
int launch(const void* W, const void* theta, void* out, int n, int64_t P, void* stream) {
  DeviceInfo* d = nullptr;
  int status = device_info(&d);
  if (status != 0) return status;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* w = static_cast<const T*>(W);
  const T* x = static_cast<const T*>(theta);
  T* o = static_cast<T*>(out);
  const int es = (int)sizeof(T);
  const int vb_w = copy_bytes((int64_t)n * es, W, W);
  const int vb_x = copy_bytes(P * es, theta, out);
  const int n8 = (n + 7) / 8 * 8;
  unsigned grid = 0;
  switch (design(n, es, d->max_smem)) {
    case kTf32x3: {
      const size_t bytes = tf32x3_smem(n8);
      status = persistent_grid(*d, 0, tf32x3_kernels[n8 / 8 - 1], kMmaThreads, bytes, n8,
                               (P + kMmaBN - 1) / kMmaBN, &grid);
      if (status != 0) return status;
      void* args[] = {&w, &x, &o, &n, &P, (void*)&vb_x};
      const cudaError_t err =
          cudaLaunchKernel(tf32x3_kernels[n8 / 8 - 1], grid, kMmaThreads, args, bytes, st);
      if (err != cudaSuccess) return (int)err;
      break;
    }
    case kResident: {
      const int threads = n8 / kTM * kCG;
      const size_t bytes = resident_smem<T>(n8);
      status = persistent_grid(*d, es == 2 ? 2 : 1, (const void*)mix_resident_kernel<T>, threads, bytes, n8,
                               (P + kBN - 1) / kBN, &grid);
      if (status != 0) return status;
      mix_resident_kernel<T><<<grid, threads, bytes, st>>>(w, x, o, n, P, n8, vb_w, vb_x);
      break;
    }
    default: {
      const size_t bytes = (2 * (size_t)kBM * padded_ld<T>(kBK) + 2 * (size_t)kBK * kBN) * es;
      const dim3 tiles((unsigned)((P + kBN - 1) / kBN), (unsigned)((n + kBM - 1) / kBM));
      mix_tiled_kernel<T><<<tiles, kTiledThreads, bytes, st>>>(w, x, o, n, P, vb_w, vb_x);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// W: (n, n) and theta, out: (n, P), all row-major in one dtype; P / 64
// below 2^31 (the grid's x limit). Returns the launch's cudaError_t.
extern "C" int gossip_mix_f32(const void* W, const void* theta, void* out, int n, int64_t P,
                              void* stream) {
  return launch<float>(W, theta, out, n, P, stream);
}

extern "C" int gossip_mix_bf16(const void* W, const void* theta, void* out, int n, int64_t P,
                               void* stream) {
  return launch<bf16>(W, theta, out, n, P, stream);
}

// The kernel gossip_mix_<dtype> runs for n nodes on the current device:
// 0 the 3xTF32 tensor-core kernel, 1 the W-resident FMA kernel, 2 the
// K-tiled FMA kernel; or -(cudaError_t).
extern "C" int gossip_mix_design(int n, int elem_bytes) {
  DeviceInfo* d = nullptr;
  const int status = device_info(&d);
  if (status != 0) return -status;
  return (int)design(n, elem_bytes, d->max_smem);
}
