// Flash attention forward for bfloat16 inputs on the Hopper tensor cores
// with wgmma (warpgroup matrix multiply).
//
// The same function as flash_attention.cu's float32 kernel (causal or
// not, sliding window, tanh softcap, GQA by index, any S >= 1, D in
// {32, 64, 128, 256}); included by it and launched for bfloat16 q, k, v.
//
// Bound on an H100: the operations, 4 D flops per kept (q, k) pair and
// head, at the 989 TFLOP/s bf16 tensor-core peak: ~0.13 ms at
// recurrentgemma-2b's layer (B 2, S 4096, H 10, D 256, window 2048).
//
// Design. One block of three warpgroups per (128-query tile, b * H + h),
// the latest (heaviest under the causal mask) tiles first. Warpgroup 0
// is the producer: one thread issues every copy with TMA (the tensor
// memory accelerator) and the warpgroup gives up registers
// (setmaxnreg.dec to 24). Warpgroups 1 and 2 are the consumers
// (setmaxnreg.inc to 240): consumer warpgroup g owns query rows 64 g ..
// 64 g + 63, its warp w rows 16 w .. 16 w + 15.
//   - Copies: the Q tile once, then K and V tiles of 64 keys through a
//     two-stage ring. Each stage has a "full" mbarrier (the producer
//     arms it with the stage's byte count; TMA completes it) and an
//     "empty" one (each of the 8 consumer warps arrives when its MMAs on
//     the stage are done; the producer waits for it before refilling).
//     No __syncthreads in the loop: the two consumer warpgroups run
//     apart, so one's softmax overlaps the other's MMAs. TMA zero-fills
//     rows past S and, for D = 32, the padding columns 32 .. 63.
//   - S = Q K^T: wgmma m64n64k16, both operands read from shared memory
//     through descriptors (f32 sums). The true D^-0.5 is applied to S in
//     f32, then the softcap, then the mask.
//   - Only tiles on the diagonal, at the window's lower edge or past S
//     are masked; a warpgroup whose rows keep no key of a tile skips it.
//     Masked logits are -inf, so their p is exactly 0; m starts at -2e9,
//     so (m_old - m_new) and (s - m_new) never meet inf - inf.
//   - P stays in registers: wgmma's accumulator fragment of S is, as
//     laid out, the register A operand of O += P V (wgmma m64nDk16, V
//     read from shared memory as an MN-major B). P is split into its
//     bf16 rounding and the bf16 rounding of the remainder, two products
//     with V: the weights keep ~16 bits, not 8, which holds the outputs
//     within a bf16 ulp of the float32 result (on an H100 at
//     recurrentgemma-2b's layer, max |error| against the float32 plain
//     version 0.0156 with one rounded P, 0.0078 with two, for 18% more
//     time). l sums the unrounded p.
//   - Shared tiles use the 128-byte swizzle that both TMA and wgmma
//     speak: a (rows x D) tile is stored as D / 64 column blocks of
//     (rows x 64), the 16-byte chunk c of row r at chunk c ^ (r % 8); one
//     TMA box fills one column block.
//   - The loop runs over the kv tiles of the causal / window band only.
//   - The epilogue scales O by 1 / l (0 for a row with l = 0), stages
//     the warp's 16 rows in its own rows of the Q tile and stores them
//     with 16-byte writes, rows past S skipped.
//   - Under autograd (kSave, o32 and lse not null) it also writes what
//     the backward (flash_attention_bwd.cu) reads: each row's
//     log-sum-exp m + log l in float32 at lse[(b H + h) S_pad + row]
//     (S_pad = S rounded up to kLsePad), and O in float32 (B, S, H, D)
//     beside the bf16 one. The inference launch is the kSave = false
//     instance: the same kernel as without these outputs.
// Shared memory: (128 + 4 * 64) * max(D, 64) * 2 bytes (+ 1 KB to align
// the swizzle atoms, + the mbarriers), 193 KB at D = 256. TMA reads
// q, k and v through tensor maps built at each launch; their addresses
// must be 16-byte aligned (ops.py makes an aligned copy of a view that
// is not).

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types (no libcuda link: see encoder())
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_wgmma {

constexpr int kBQ = 128;
constexpr int kBKV = 64;
constexpr int kThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kStages = 2;     // K / V ring
constexpr float kNegInf = -2.0e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kLsePad = 128;   // the saved lse's rows: S rounded up to a multiple of this

using bf16 = __nv_bfloat16;

template <int D>
struct Tile {
  static constexpr int DP = D < 64 ? 64 : D;  // stored row width (D = 32 zero-padded)
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = kBKV * DP * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;  // mbarriers after the tiles
  static constexpr size_t bytes = (size_t)kBarOffset + 1024 + 64;
};

// byte offset of the 16-byte chunk holding (r, c .. c + 7) in a swizzled
// (rows x DP) tile: column block c / 64, row r, chunk (c % 64) / 8 ^ r % 8
__device__ __forceinline__ int swz(int r, int c, int rows) {
  return (c / 64) * rows * 128 + r * 128 + ((((c % 64) / 8) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival that also arms the barrier for `bytes` of TMA transfers
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one TMA box of a 4-D (D, heads, S, B) tensor map into shared memory at
// dst, completing `bytes` on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int head, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head), "r"(s), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, LBO
// (K-major: unused; MN-major: between 64-column blocks), SBO (between
// 8-row groups), layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_n64_ss(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64_rs(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128_rs(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256_rs(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  if constexpr (N == 64) wgmma_n64_rs(d, a0, a1, a2, a3, desc_b);
  else if constexpr (N == 128) wgmma_n128_rs(d, a0, a1, a2, a3, desc_b);
  else wgmma_n256_rs(d, a0, a1, a2, a3, desc_b);
}

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x, y rounded to a bf16 pair (hi), and their remainders rounded to
// another (lo)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x - f.x, y - f.y);
}

// rows [r0, r0 + ROWS) of one head, all DP columns, as DP / 64 TMA boxes
// (one per swizzled column block of the tile)
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t tile, const CUtensorMap* map, uint32_t bar,
                                          int head, int r0, int b) {
#pragma unroll
  for (int cb = 0; cb < Tile<D>::DP / 64; ++cb) tma_load(tile + cb * ROWS * 128, map, bar, cb * 64, head, r0, b);
}

template <int D, bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                       float* __restrict__ o32, float* __restrict__ lse, int S, int H, int Hkv,
                       int causal, int window, float softcap, float scale) {
  constexpr int DP = Tile<D>::DP;
  constexpr int NT = DP / 8;  // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: align the tiles to 1024 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t Qs = base;
  const uint32_t KV = base + Tile<D>::kQBytes;  // stage s: K at KV + 2 s kKVBytes, V after it
  const uint32_t q_full = base + Tile<D>::kBarOffset;
  const uint32_t full = q_full + 8;                // stage s at full + 8 s
  const uint32_t empty = full + 8 * kStages;       // stage s at empty + 8 s

  const int tid = threadIdx.x;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * D;
  bf16* ob = out + (int64_t)b * S * q_stride + (int64_t)h * D;

  // kv tiles holding a kept key for some query of the block
  const int q_last = min(q0 + kBQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const int t_lo = k_lo / kBKV;
  const int t_hi = k_hi / kBKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, Tile<D>::kQBytes);
      load_rows<D, kBQ>(Qs, &tq, q_full, h, q0, b);
      for (int t = t_lo; t <= t_hi; ++t) {
        const int i = t - t_lo, st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, (i / kStages - 1) & 1);
        const uint32_t Ks = KV + st * 2 * Tile<D>::kKVBytes;
        mbar_expect_tx(full + 8 * st, 2 * Tile<D>::kKVBytes);
        load_rows<D, kBKV>(Ks, &tk, full + 8 * st, hk, t * kBKV, b);
        load_rows<D, kBKV>(Ks + Tile<D>::kKVBytes, &tv, full + 8 * st, hk, t * kBKV, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int warp = tid / 32 - 4;  // consumer warp 0 .. 7
  const int wg = warp / 4;
  const int lane = tid % 32;
  const int gq0 = q0 + wg * 64;  // this warpgroup's first query row
  const int gq_last = gq0 + 63;
  const int qr0 = q0 + warp * 16 + lane / 4;  // this thread's rows: qr0 and qr0 + 8

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_full, 0);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int i = t - t_lo, st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);

    const int k0 = t * kBKV;
    const bool any = k0 < S && (!causal || k0 <= gq_last) &&
                     (window <= 0 || k0 + kBKV - 1 > gq0 - window);
    if (any) {  // warpgroup-uniform
      const bool full_tile = k0 + kBKV <= S && (!causal || k0 + kBKV - 1 <= gq0) &&
                             (window <= 0 || k0 > gq_last - window);
      const uint32_t Ks = KV + st * 2 * Tile<D>::kKVBytes;
      const uint32_t Vs = Ks + Tile<D>::kKVBytes;

      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        // K-major A (this warpgroup's 64 Q rows) and B (the 64 K rows):
        // column block ks / 4, 32 bytes a k16 step inside it
        const uint32_t a = Qs + (ks / 4) * kBQ * 128 + wg * 64 * 128 + (ks % 4) * 32;
        const uint32_t bk = Ks + (ks / 4) * kBKV * 128 + (ks % 4) * 32;
        wgmma_n64_ss(&s[0][0], desc(a, 16, 1024), desc(bk, 16, 1024));
      }
      wg_commit();
      wg_wait0();

      // scale, softcap, mask; s[j][0..1] are row qr0, s[j][2..3] row qr0 + 8,
      // keys k0 + 8 j + 2 (lane % 4) + {0, 1}
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (!full_tile) {
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int qpos = qr0 + (e >> 1) * 8;
            const bool keep = kpos < S && (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window);
            if (!keep) x = -INFINITY;
          }
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: m >= -2e9
      const float al0 = exp2f((m0 - mn0) * kLog2e), al1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;  // this thread's share of the row sums
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f((s[j][0] - mn0) * kLog2e);  // exp2(-inf) = 0 exactly
        s[j][1] = exp2f((s[j][1] - mn0) * kLog2e);
        s[j][2] = exp2f((s[j][2] - mn1) * kLog2e);
        s[j][3] = exp2f((s[j][3] - mn1) * kLog2e);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }

      // O += P V: S's fragment of keys 16 kk .. 16 kk + 15 is the A operand;
      // B = V rows 16 kk .., MN-major (d contiguous), all DP columns. P is
      // split into a bf16 part and the bf16 rounding of its remainder, so
      // the products keep ~16 bits of each weight, not 8.
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
        split(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
        split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
        split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc(Vs + kk * 16 * 128, kBKV * 128, 1024);
        wgmma_rs<DP>(&o[0][0], ph[kk][0], ph[kk][1], ph[kk][2], ph[kk][3], dv);
        wgmma_rs<DP>(&o[0][0], pl[kk][0], pl[kk][1], pl[kk][2], pl[kk][3], dv);
      }
      wg_commit();
      wg_wait0();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if constexpr (kSave) {
    // the backward's inputs: rows qr0 and qr0 + 8 (those before S), the
    // columns before D (D = 32 computes 64)
    const int s_pad = (S + kLsePad - 1) / kLsePad * kLsePad;
    float* lrow = lse + (int64_t)blockIdx.y * s_pad;
    float* ob32 = o32 + (int64_t)b * S * q_stride + (int64_t)h * D;
    if (lane % 4 == 0) {
      if (qr0 < S) lrow[qr0] = m0 + logf(l0);
      if (qr0 + 8 < S) lrow[qr0 + 8] = m1 + logf(l1);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * (lane % 4);
      if (c >= D) continue;
      if (qr0 < S)
        *reinterpret_cast<float2*>(ob32 + (int64_t)qr0 * q_stride + c) =
            make_float2(o[j][0] * inv0, o[j][1] * inv0);
      if (qr0 + 8 < S)
        *reinterpret_cast<float2*>(ob32 + (int64_t)(qr0 + 8) * q_stride + c) =
            make_float2(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
  // stage the warp's rows in its own rows of the (swizzled) Q tile, which
  // only this warp's finished MMAs read, then 16-byte stores
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8;
    const int off = 4 * (lane % 4);  // bytes inside the chunk
    *reinterpret_cast<uint32_t*>(gbase + swz(r0, c, kBQ) + off) = pack(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(gbase + swz(r0 + 8, c, kBQ) + off) =
        pack(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = 0; i < (16 * CPR + 31) / 32; ++i) {
    const int e = lane + i * 32;
    const int r = e / CPR, c = (e % CPR) * 8;
    const int row = q0 + warp * 16 + r;
    if (e < 16 * CPR && row < S)
      *reinterpret_cast<uint4*>(ob + (int64_t)row * q_stride + c) =
          *reinterpret_cast<const uint4*>(gbase + swz(warp * 16 + r, c, kBQ));
  }
}

// the driver's cuTensorMapEncodeTiled, found through the runtime (the
// library links no libcuda); null if the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor as a 4-D tensor map (D, heads, S, B),
// boxes of (64, 1, rows, 1) with the 128-byte swizzle; zero fill out of
// bounds (rows past S, columns past D = 32)
inline int tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool kSave>
int launch_d(const void* q, const void* k, const void* v, void* out, void* o32, void* lse, int B,
             int S, int H, int Hkv, int causal, int window, float softcap, float scale,
             cudaStream_t stream) {
  constexpr size_t bytes = Tile<D>::bytes;
  // the runtime call first: on a thread where the runtime has not yet made
  // the device's primary context current (autograd's, recomputing a
  // forward under remat), the tensor-map encoder (a driver call) fails
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, kSave>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  int status;
  if ((status = tensor_map(&tq, q, B, S, H, D, kBQ)) != 0 ||
      (status = tensor_map(&tk, k, B, S, Hkv, D, kBKV)) != 0 ||
      (status = tensor_map(&tv, v, B, S, Hkv, D, kBKV)) != 0)
    return status;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_wgmma_kernel<D, kSave><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(o32), static_cast<float*>(lse), S,
      H, Hkv, causal, window, softcap, scale > 0.f ? scale : (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_saving(const void* q, const void* k, const void* v, void* out, void* o32, void* lse,
                  int B, int S, int H, int Hkv, int causal, int window, float softcap,
                  float scale, cudaStream_t st) {
  return lse != nullptr
             ? launch_d<D, true>(q, k, v, out, o32, lse, B, S, H, Hkv, causal, window, softcap,
                                 scale, st)
             : launch_d<D, false>(q, k, v, out, o32, lse, B, S, H, Hkv, causal, window, softcap,
                                  scale, st);
}

// o32 and lse both null (inference) or both set (a forward under autograd)
inline int launch(const void* q, const void* k, const void* v, void* out, void* o32, void* lse,
                  int B, int S, int H, int Hkv, int D, int causal, int window, float softcap,
                  float scale, void* stream) {
  if ((o32 == nullptr) != (lse == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_saving<32>(q, k, v, out, o32, lse, B, S, H, Hkv, causal, window, softcap, scale, st);
    case 64: return launch_saving<64>(q, k, v, out, o32, lse, B, S, H, Hkv, causal, window, softcap, scale, st);
    case 128: return launch_saving<128>(q, k, v, out, o32, lse, B, S, H, Hkv, causal, window, softcap, scale, st);
    case 256: return launch_saving<256>(q, k, v, out, o32, lse, B, S, H, Hkv, causal, window, softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_wgmma
