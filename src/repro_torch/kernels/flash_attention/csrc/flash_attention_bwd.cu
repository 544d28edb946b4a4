// Flash attention backward for bfloat16 inputs on the Hopper tensor cores
// with wgmma: the gradients of flash_attention_wgmma.cuh's forward.
//
//   p_ij  = exp(y_ij - lse_i),  y_ij = cap tanh(x_ij / cap) (y = x when
//           cap = 0),  x_ij = (q_i . k_j) D^-0.5,  kept pairs only
//   dv_j  = sum_i p_ij do_i                      (summed over the GQA group)
//   ds_ij = p_ij (do_i . v_j - delta_i) (1 - tanh^2) D^-0.5,
//           delta_i = do_i . o_i (the float32 output)
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i   (dk over the group)
//
// q, dq, do: (B, S, H, D) bf16; k, v, dk, dv: (B, S, Hkv, D) bf16; o32
// (B, S, H, D) float32 and lse (B, H, S_pad) float32 from the forward
// (S_pad = S rounded up to kLsePad); delta (B, H, S_pad) float32 scratch.
// The same contract as the forward: causal or not, sliding window, tanh
// softcap, GQA by index, any S >= 1, D in {32, 64, 128, 256}.
//
// Replaces: nothing on the TPU side (the reference's Pallas kernel has
// no backward; the reference trains through plain XLA attention). It
// takes the training step's attention off the plain float32 path.
//
// Bound on an H100: the operations. Per kept (q, k) pair and head the
// gradients need 10 D flops (S = Q K^T recomputed, dP = dO V^T, dV, dK,
// dQ: 2 D each); these kernels execute 20 D (S and dP in both kernels,
// each product with P or dS in two parts). At qwen3-0.6b's layer (B 2,
// S 1024, H 16, Hkv 8, D 128, causal) that is 21.5 GFLOP needed, 0.022 ms
// at the 989 TFLOP/s bf16 peak (43 GFLOP executed, 0.044 ms).
//
// Precision: that of the forward and of the plain float32 attention.
// Products of bf16 operands are exact and sum in float32; the float32
// operands P and dS enter wgmma as two bf16 parts (the bf16 rounding and
// the bf16 rounding of the remainder, ~16 bits of each). The softcap's
// derivative, the mask and delta are float32; dq, dk, dv are rounded to
// bf16 once. No atomics: every output element is written by one thread
// after a fixed-order sum, so a call is bitwise repeatable.
//
// Design: two kernels, each a TMA producer warpgroup (setmaxnreg.dec 24,
// one thread issuing every copy) and two wgmma consumer warpgroups
// (setmaxnreg.inc 240), the forward's layout and barriers.
//   - flash_bwd_dq_kernel (launched first), one block a (b, h, query
//     tile), the heaviest (latest, under the causal mask) tiles first:
//     delta for its rows from o32 and do (float32, a fixed order), written
//     to scratch for the other kernel; then over the kv tiles of the band
//     (64 keys, a two-stage ring) S = Q K^T and dP = dO V^T (both operands
//     K-major in shared memory), dS in registers, dQ += dS K (dS from
//     registers as the A operand, K read MN-major).
//   - flash_bwd_dkdv_kernel, one block a (b, kv head, kv tile), the
//     longest (earliest, under the causal mask) kv tiles first: K and V
//     stay in shared memory; the Q and dO tiles (64 rows) of every query
//     head of the GQA group, with their lse and delta, stream through a
//     two-stage ring, only those of the causal / window band. S^T = K Q^T
//     and dP^T = V dO^T, so that the accumulator fragments of P^T and
//     dS^T are the A operands of dV += P^T dO and dK += dS^T Q (dO and Q
//     read MN-major). Summing the group inside the block is what stands
//     in for atomics.
//   A tile with no kept pair for a warpgroup's rows is skipped by it; only
//   tiles on the diagonal, at the window's edge or past S are masked.
//   At D <= 128 the two consumer warpgroups own 64 rows each of a
//   128-row stationary tile; at D = 256 (whose accumulators would not fit
//   in registers) they share a 64-row tile and own half the columns each,
//   both computing its S and dP.
//   The epilogues write bf16 pairs straight from the accumulators.

#include "flash_attention_wgmma.cuh"

namespace flash_bwd {

using namespace flash_wgmma;

constexpr int kRows = 64;  // a warpgroup's rows; the streamed tiles' rows

template <int D>
struct Shape {
  static constexpr int DP = D < 64 ? 64 : D;  // stored row width (D = 32 zero-padded)
  static constexpr bool kSplitD = D == 256;   // warpgroups split the columns, not the rows
  static constexpr int TR = kSplitD ? 64 : 128;  // rows of a block's stationary tile
  static constexpr int NA = kSplitD ? DP / 2 : DP;  // a warpgroup's accumulator columns
  static constexpr int kStatBytes = TR * DP * 2;     // one stationary tile
  static constexpr int kStreamBytes = kRows * DP * 2;  // one streamed tile
  // dQ: Q, dO stationary; a ring of K, V
  static constexpr int kDqBar = 2 * kStatBytes + 2 * kStages * kStreamBytes;
  static constexpr size_t dq_bytes = (size_t)kDqBar + 1024 + 64;
  // dK / dV: K, V stationary; a ring of Q, dO, then each stage's lse and delta
  static constexpr int kVec = 2 * kStatBytes + 2 * kStages * kStreamBytes;
  static constexpr int kKvBar = kVec + kStages * 2 * kRows * 4;
  static constexpr size_t kv_bytes = (size_t)kKvBar + 1024 + 64;
};

// `bytes` from global memory at src into shared memory at dst, completing
// on the mbarrier bar (both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 32 accumulators of an m64n64 tile, zeroed
__device__ __forceinline__ void zero8(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// acc (+)= A B over 64 rows of K-major A at a (rows stride 128 B inside a
// column block of `arows` rows) and 64 rows of K-major B at bt (a column
// block of 64 rows): all DP columns of the shared dimension
template <int DP, int AROWS>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], uint32_t a, uint32_t bt) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_n64_ss(&acc[0][0], desc(a + (ks / 4) * AROWS * 128 + (ks % 4) * 32, 16, 1024),
                 desc(bt + (ks / 4) * kRows * 128 + (ks % 4) * 32, 16, 1024));
}

// acc (+)= X B: X (64 x 64, f32, an accumulator fragment) as two bf16
// parts from registers; B = 64 rows of an MN-major tile at bt, NA columns
// from column block c0 / 64
template <int NA>
__device__ __forceinline__ void mma_split(float* acc, const float (&x)[8][4], uint32_t bt, int c0) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    split(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc(bt + (c0 / 64) * kRows * 128 + kk * 16 * 128, kRows * 128, 1024);
    wgmma_rs<NA>(acc, hi[kk][0], hi[kk][1], hi[kk][2], hi[kk][3], db);
    wgmma_rs<NA>(acc, lo[kk][0], lo[kk][1], lo[kk][2], lo[kk][3], db);
  }
  wg_commit();
  wg_wait0();
}

// y = the capped logit of x, and dy/dx
__device__ __forceinline__ float cap_logit(float x, float softcap, float& dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    dcap = 1.f - t * t;
    return softcap * t;
  }
  dcap = 1.f;
  return x;
}

__device__ __forceinline__ bool kept(int qpos, int kpos, int S, int causal, int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// bf16 pairs of a warpgroup's accumulator rows r and r + 8 (global rows
// of a (B, S, heads, D) tensor at `rows`, row stride `stride`), columns
// c0 + 8 j + 2 (lane % 4) before D, rows before S
template <int D, int NT>
__device__ __forceinline__ void store_rows(bf16* rows, int64_t stride, float (*acc)[4], int r,
                                           int S, int c0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + j * 8 + 2 * (lane % 4);
    if (c >= D) continue;
    if (r < S) *reinterpret_cast<uint32_t*>(rows + (int64_t)r * stride + c) = pack(acc[j][0], acc[j][1]);
    if (r + 8 < S)
      *reinterpret_cast<uint32_t*>(rows + (int64_t)(r + 8) * stride + c) = pack(acc[j][2], acc[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ o32, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, int H, int Hkv, int causal, int window, float softcap, float scale) {
  using T = Shape<D>;
  constexpr int DP = T::DP, TR = T::TR, NA = T::NA, NT = NA / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qs = base, dOs = base + T::kStatBytes;
  const uint32_t ring = base + 2 * T::kStatBytes;  // stage s: K at ring + 2 s kStreamBytes, V after
  const uint32_t q_full = base + T::kDqBar;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int n_qt = (S + TR - 1) / TR;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * TR;
  const int q_last = min(q0 + TR - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const int t_lo = k_lo / kRows, t_hi = k_hi / kRows;

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
      mbar_expect_tx(q_full, 2 * T::kStatBytes);
      load_rows<D, TR>(Qs, &tq, q_full, h, q0, b);
      load_rows<D, TR>(dOs, &tdo, q_full, h, q0, b);
      for (int t = t_lo; t <= t_hi; ++t) {
        const int i = t - t_lo, st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, (i / kStages - 1) & 1);
        const uint32_t Ks = ring + st * 2 * T::kStreamBytes;
        mbar_expect_tx(full + 8 * st, 2 * T::kStreamBytes);
        load_rows<D, kRows>(Ks, &tk, full + 8 * st, hk, t * kRows, b);
        load_rows<D, kRows>(Ks + T::kStreamBytes, &tv, full + 8 * st, hk, t * kRows, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int warp = tid / 32 - 4;  // consumer warp 0 .. 7
  const int wg = warp / 4, lane = tid % 32;
  const int r0 = T::kSplitD ? 0 : wg * kRows;  // this warpgroup's first row in the tile
  const int c0 = T::kSplitD ? wg * NA : 0;     // its first accumulator column
  const int gq0 = q0 + r0, gq_last = gq0 + kRows - 1;
  const int qa = gq0 + (warp % 4) * 16 + lane / 4;  // this thread's rows: qa and qa + 8
  const int64_t q_stride = (int64_t)H * D;
  const int64_t row_base = (int64_t)bh * ((S + kLsePad - 1) / kLsePad * kLsePad);

  // delta = do . o for rows qa and qa + 8: lane % 4 sums its quarter of the
  // columns, then the quad adds in a fixed order
  float dl[2], ls[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = qa + 8 * e;
    float acc = 0.f;
    if (row < S) {
      const int64_t off = ((int64_t)b * S + row) * q_stride + (int64_t)h * D + (lane % 4) * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 8) {
        const uint4 g = *reinterpret_cast<const uint4*>(dout + off + c);
        const float4 oa = *reinterpret_cast<const float4*>(o32 + off + c);
        const float4 ob = *reinterpret_cast<const float4*>(o32 + off + c + 4);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&g);
        const float2 g0 = __bfloat1622float2(gp[0]), g1 = __bfloat1622float2(gp[1]);
        const float2 g2 = __bfloat1622float2(gp[2]), g3 = __bfloat1622float2(gp[3]);
        acc = fmaf(g0.x, oa.x, acc); acc = fmaf(g0.y, oa.y, acc);
        acc = fmaf(g1.x, oa.z, acc); acc = fmaf(g1.y, oa.w, acc);
        acc = fmaf(g2.x, ob.x, acc); acc = fmaf(g2.y, ob.y, acc);
        acc = fmaf(g3.x, ob.z, acc); acc = fmaf(g3.y, ob.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[e] = acc;
    ls[e] = row < S ? lse[row_base + row] : 0.f;
    if (lane % 4 == 0 && (!T::kSplitD || wg == 0)) delta[row_base + row] = acc;
  }

  float dqa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  mbar_wait(q_full, 0);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int i = t - t_lo, st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    const int k0 = t * kRows;
    const bool any = k0 < S && gq0 < S && (!causal || k0 <= gq_last) &&
                     (window <= 0 || k0 + kRows - 1 > gq0 - window);
    if (any) {  // warpgroup-uniform
      const bool full_tile = k0 + kRows <= S && gq_last < S && (!causal || k0 + kRows - 1 <= gq0) &&
                             (window <= 0 || k0 > gq_last - window);
      const uint32_t Ks = ring + st * 2 * T::kStreamBytes, Vs = Ks + T::kStreamBytes;
      float s[8][4], dp[8][4];
      zero8(s);
      zero8(dp);
      wg_fence();
      mma_rows<DP, TR>(s, Qs + r0 * 128, Ks);
      mma_rows<DP, TR>(dp, dOs + r0 * 128, Vs);
      wg_commit();
      wg_wait0();
      // s[j][0..1]: row qa, s[j][2..3]: row qa + 8; keys k0 + 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dcap;
          const float y = cap_logit(s[j][e] * scale, softcap, dcap);
          const bool keep =
              full_tile || kept(qa + (e >> 1) * 8, k0 + 8 * j + 2 * (lane % 4) + (e & 1), S, causal, window);
          const float p = keep ? exp2f((y - ls[e >> 1]) * kLog2e) : 0.f;
          dp[j][e] = keep ? p * (dp[j][e] - dl[e >> 1]) * dcap * scale : 0.f;
        }
      }
      mma_split<NA>(&dqa[0][0], dp, Ks, c0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the stage
  }

  store_rows<D, NT>(dq + (int64_t)b * S * q_stride + (int64_t)h * D, q_stride, dqa, qa, S, c0, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int Hkv,
                      int causal, int window, float softcap, float scale) {
  using T = Shape<D>;
  constexpr int DP = T::DP, TR = T::TR, NA = T::NA, NT = NA / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t Ks = base, Vs = base + T::kStatBytes;
  const uint32_t ring = base + 2 * T::kStatBytes;  // stage s: Q at ring + 2 s kStreamBytes, dO after
  const uint32_t vec = base + T::kVec;             // stage s: lse at vec + 512 s, delta 256 after
  const uint32_t kv_full = base + T::kKvBar;
  const uint32_t full = kv_full + 8, empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv, hk = bh % Hkv;
  const int G = H / Hkv;
  const int k0 = (int)blockIdx.y * TR;
  const int k_last = min(k0 + TR - 1, S - 1);
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const int t_lo = q_lo / kRows;
  const int n_t = q_hi / kRows - t_lo + 1;  // query tiles of the band, a head
  const int steps = G * n_t;
  const int s_pad = (S + kLsePad - 1) / kLsePad * kLsePad;

  if (tid == 0) {
    mbar_init(kv_full, 1);
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
      mbar_expect_tx(kv_full, 2 * T::kStatBytes);
      load_rows<D, TR>(Ks, &tk, kv_full, hk, k0, b);
      load_rows<D, TR>(Vs, &tv, kv_full, hk, k0, b);
      for (int i = 0; i < steps; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, (i / kStages - 1) & 1);
        const int h = hk * G + i / n_t, q0 = (t_lo + i % n_t) * kRows;
        const uint32_t Qst = ring + st * 2 * T::kStreamBytes;
        const int64_t row = ((int64_t)b * H + h) * s_pad + q0;
        mbar_expect_tx(full + 8 * st, 2 * T::kStreamBytes + 2 * kRows * 4);
        load_rows<D, kRows>(Qst, &tq, full + 8 * st, h, q0, b);
        load_rows<D, kRows>(Qst + T::kStreamBytes, &tdo, full + 8 * st, h, q0, b);
        bulk_load(vec + st * 2 * kRows * 4, lse + row, kRows * 4, full + 8 * st);
        bulk_load(vec + st * 2 * kRows * 4 + kRows * 4, delta + row, kRows * 4, full + 8 * st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int warp = tid / 32 - 4;  // consumer warp 0 .. 7
  const int wg = warp / 4, lane = tid % 32;
  const int r0 = T::kSplitD ? 0 : wg * kRows;  // this warpgroup's first key row in the tile
  const int c0 = T::kSplitD ? wg * NA : 0;     // its first accumulator column
  const int gk0 = k0 + r0, gk_last = gk0 + kRows - 1;
  const int ka = gk0 + (warp % 4) * 16 + lane / 4;  // this thread's keys: ka and ka + 8

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }
  mbar_wait(kv_full, 0);

  for (int i = 0; i < steps; ++i) {
    const int st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    const int q0 = (t_lo + i % n_t) * kRows, q_last = q0 + kRows - 1;
    const bool any = gk0 < S && q0 < S && (!causal || gk0 <= q_last) &&
                     (window <= 0 || q0 < gk_last + window);
    if (any) {  // warpgroup-uniform
      const bool full_tile = gk_last < S && q_last < S && (!causal || gk_last <= q0) &&
                             (window <= 0 || q_last < gk0 + window);
      const uint32_t Qst = ring + st * 2 * T::kStreamBytes, dOst = Qst + T::kStreamBytes;
      const float* lse_s = reinterpret_cast<const float*>(gbase + (vec - base) + st * 2 * kRows * 4);
      const float* del_s = lse_s + kRows;
      float s[8][4], dp[8][4];
      zero8(s);
      zero8(dp);
      wg_fence();
      mma_rows<DP, TR>(s, Ks + r0 * 128, Qst);
      mma_rows<DP, TR>(dp, Vs + r0 * 128, dOst);
      wg_commit();
      wg_wait0();
      // s[j][0..1]: key ka, s[j][2..3]: key ka + 8; queries q0 + 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * (lane % 4);
        const float2 L = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 Dl = *reinterpret_cast<const float2*>(del_s + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dcap;
          const float y = cap_logit(s[j][e] * scale, softcap, dcap);
          const bool keep = full_tile || kept(q0 + qc + (e & 1), ka + (e >> 1) * 8, S, causal, window);
          const float p = keep ? exp2f((y - ((e & 1) ? L.y : L.x)) * kLog2e) : 0.f;
          dp[j][e] = keep ? p * (dp[j][e] - ((e & 1) ? Dl.y : Dl.x)) * dcap * scale : 0.f;
          s[j][e] = p;
        }
      }
      mma_split<NA>(&dva[0][0], s, dOst, c0);
      mma_split<NA>(&dka[0][0], dp, Qst, c0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the stage
  }

  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t off = (int64_t)b * S * kv_stride + (int64_t)hk * D;
  store_rows<D, NT>(dk + off, kv_stride, dka, ka, S, c0, lane);
  store_rows<D, NT>(dv + off, kv_stride, dva, ka, S, c0, lane);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* dout, const void* o32,
             const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
             int Hkv, int causal, int window, float softcap, float logit_scale,
             cudaStream_t stream) {
  using T = Shape<D>;
  const float scale = logit_scale > 0.f ? logit_scale : (float)(1.0 / sqrt((double)D));
  // runtime calls first: autograd runs the backward on a thread of its own,
  // where the tensor-map encoder (a driver call) finds no current context
  // until the runtime has made the device's primary context current
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)T::kv_bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tdo, tk, tv;
  int status;
  // dQ (and delta) first: Q, dO stationary (TR-row boxes), K, V streamed
  if ((status = tensor_map(&tq, q, B, S, H, D, T::TR)) != 0 ||
      (status = tensor_map(&tdo, dout, B, S, H, D, T::TR)) != 0 ||
      (status = tensor_map(&tk, k, B, S, Hkv, D, kRows)) != 0 ||
      (status = tensor_map(&tv, v, B, S, Hkv, D, kRows)) != 0)
    return status;
  flash_bwd_dq_kernel<D><<<dim3((unsigned)(B * H), (unsigned)((S + T::TR - 1) / T::TR)), kThreads,
                           T::dq_bytes, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(o32), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), S, H, Hkv,
      causal, window, softcap, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dK, dV: K, V stationary (TR-row boxes), Q, dO streamed
  if ((status = tensor_map(&tq, q, B, S, H, D, kRows)) != 0 ||
      (status = tensor_map(&tdo, dout, B, S, H, D, kRows)) != 0 ||
      (status = tensor_map(&tk, k, B, S, Hkv, D, T::TR)) != 0 ||
      (status = tensor_map(&tv, v, B, S, Hkv, D, T::TR)) != 0)
    return status;
  flash_bwd_dkdv_kernel<D><<<dim3((unsigned)(B * Hkv), (unsigned)((S + T::TR - 1) / T::TR)),
                             kThreads, T::kv_bytes, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, Hkv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd

// q, dout, dq: (B, S, H, D) bf16; k, v, dk, dv: (B, S, Hkv, D) bf16; o32
// (B, S, H, D) and lse (B, H, S_pad) float32, the forward's (S_pad = S
// rounded up to a multiple of 128); delta (B, H, S_pad) float32 scratch.
// q, k, v and dout 16-byte aligned (TMA reads them), Hkv divides H, D in
// {32, 64, 128, 256}, S >= 1. window <= 0 means no window; softcap <= 0
// no softcap; scale is the forward's (D^-0.5 where <= 0). Two launches on `stream`; returns the first failure's
// cudaError_t (cudaErrorInvalidValue for another D, cudaErrorNotSupported
// if the driver has no tensor-map encoder).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* o32, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B, int S,
                                        int H, int Hkv, int D, int causal, int window,
                                        float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define FLASH_BWD_CASE(d)                                                                       \
  case d:                                                                                       \
    return flash_bwd::launch_d<d>(q, k, v, dout, o32, lse, delta, dq, dk, dv, B, S, H, Hkv,     \
                                  causal, window, softcap, scale, st);
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
#undef FLASH_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
