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
// so each element leaves HBM once however many atoms gather it. Two
// kernels here, picked by dtype and shape in plan() below:
//
// staged (schedule_staged, float32): a block owns a column range of all
//   n rows, the rows' bytes split evenly over a persistent grid (one
//   block an SM, more where the tile is small) at 16-byte boundaries, and
//   walks it in tiles of n rows x kW bytes. Each tile is copied from
//   device memory into shared memory once and every output row of it is
//   computed from there, so theta is read from HBM once and the L gathers
//   of an element cost shared-memory reads (~33 TB/s across the card
//   against the L2's ~5.5). The tiles pass through a ring of up to 8
//   stages: the copies of the next stages - 1 tiles (16-byte cp.async)
//   are in flight while tile t is gathered. A task is one output row's
//   8 lanes (a quarter warp reads 128 contiguous bytes of one source row,
//   conflict-free), each lane kW / 128 vectors of 4 floats; the block
//   size is fitted to a tile's tasks (416 threads at n = 100), so no round
//   of them runs nearly empty. A lane reads its atoms' source offsets and
//   weights 2-4 at a time, issues the data reads of 2-8 atoms before it
//   adds them in order, and stores its sums straight to device memory
//   (16-byte streaming stores). A tile is copied as 16-byte chunks from
//   each row's address rounded down to 16 bytes, cut at the tile's end,
//   so any P and any alignment take 16-byte copies; a row whose data does
//   not start on the 16-byte grid sits shift(r) elements into its staged
//   row. The source rows perms[l, i] (as offsets of staged rows, shift
//   included) and the weights gammas[l] are staged once per block, after
//   the first tiles' copies are issued. kW is the widest of 512, 256, 128
//   and 64 bytes that leaves two ring stages, else 64 with one. On an
//   H100 the gathers, not the copies, bound it: two rounded float32
//   operations an element and atom (no FMA) plus the shared reads.
// l2 gather (gather_vec / gather_scalar, the kernel of the first port):
//   for bfloat16, where the staged kernel, tried, ran ~5% slower on an
//   H100 (its gathers add a conversion an element and atom, and at 2
//   bytes an element the copies are too short to hide them), and for n
//   so large that the perms table and one 64-byte stage of all n rows do
//   not fit in a block's 227 KB. One block owns one output row over one
//   chunk of columns, the row index fastest in the grid, so the L gathers
//   of a chunk find the source rows in the 50 MB L2 after their first
//   read.
// Both add the atoms in order l = 0..L-1 as a rounded multiply then a
// rounded add in float32 (no FMA contraction), the arithmetic of the
// plain version (ref.py) and the reference, so float32 results agree
// bitwise with it; zero-weight padding atoms (ScheduleArrays) add exact
// zeros. Ragged P is masked at the stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxThreads = 512;  // staged kernel: a block's threads, at most
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 64;
// l2 gather kernels
constexpr int kThreads = 256;
constexpr int kAtomTile = 256;   // atoms staged in shared memory per pass
constexpr int kScalarUnroll = 4; // independent scalar loads per thread per atom
constexpr int kVecUnroll = 2;    // independent 16-byte loads per thread per atom
constexpr int kMaxGridY = 65535;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
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

template <> struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` committed copy groups are in flight
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// atoms a staged row's table holds: L rounded up to a multiple of 8
__host__ __device__ int padded_atoms(int L) { return (L + 7) / 8 * 8; }
// shared bytes of the staged kernel before its ring: the gammas, then
// an (n, padded_atoms(L)) table of source-row offsets
__host__ __device__ size_t atoms_bytes(int n, int L) {
  return (size_t)padded_atoms(L) * 4 * (1 + (size_t)n);
}
// one ring stage: n staged rows of kW bytes plus one chunk for a shift
__host__ __device__ size_t stage_bytes(int n, int kw) { return (size_t)n * (kw + 16); }

// ---------------------------------------------------------------------------
// staged: a column tile of all n rows in shared memory
// ---------------------------------------------------------------------------


// U consecutive atoms' source offsets and weights from shared memory, in
// 16-byte reads (8-byte where U = 2); both start at a multiple of U.
template <int U>
__device__ __forceinline__ void read_atoms(int* off, float* g, const int* src, const float* gam) {
  if constexpr (U >= 4) {
#pragma unroll
    for (int u = 0; u < U; u += 4) {
      *reinterpret_cast<int4*>(off + u) = *reinterpret_cast<const int4*>(src + u);
      *reinterpret_cast<float4*>(g + u) = *reinterpret_cast<const float4*>(gam + u);
    }
  } else {
    *reinterpret_cast<int2*>(off) = *reinterpret_cast<const int2*>(src);
    *reinterpret_cast<float2*>(g) = *reinterpret_cast<const float2*>(gam);
  }
}

// Block b owns bytes [first, last) of every row: the row's bytes split
// evenly over the grid at 16-byte boundaries, so no block has a tile
// more than another; it cuts them into n_tiles tiles of `width` = kW
// bytes, the last one shorter (its tasks past the end are skipped).
struct Range {
  int64_t first, last, width;
  int64_t n_tiles;
};

__device__ __forceinline__ Range block_range(int64_t row_bytes, int kw) {
  Range r;
  const int64_t G = gridDim.x, b = blockIdx.x;
  r.first = (b * row_bytes / G) & ~int64_t(15);
  r.last = b + 1 == G ? row_bytes : ((b + 1) * row_bytes / G) & ~int64_t(15);
  const int64_t bytes = r.last - r.first;
  r.n_tiles = (bytes + kw - 1) / kw;
  r.width = kw;
  return r;
}

// float32 only (bfloat16 runs the l2 gather: see plan()). kW: bytes a
// staged row holds (plus one chunk for a shift); kVec: P % 4 == 0 and
// theta, out 16-byte aligned (every row starts on the grid: no shift,
// 16-byte shared reads and global stores), else element-wise reads and
// stores. Any block size that is a multiple of 32 (launch() fits it to
// the tile's tasks).
template <int kW, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
schedule_staged(const float* __restrict__ theta, const float* __restrict__ gammas,
                const int* __restrict__ perms, float* __restrict__ out, int n, int64_t P, int L,
                int stages) {
  using T = float;
  constexpr int es = (int)sizeof(T);
  constexpr int kChunks = kW / 16 + (kVec ? 0 : 1);  // 16-byte copies a row, at most
  constexpr int kRow = (kW + 16) / es;              // elements of a staged row
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = padded_atoms(L);
  float* s_g = reinterpret_cast<float*>(smem);  // gammas, 0 past L
  int* s_src = reinterpret_cast<int*>(smem + Lp * 4);  // [i][l]: row perms[l, i]'s offset
  unsigned char* ring = smem + atoms_bytes(n, L);
  const int stage = (int)stage_bytes(n, kW);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t row_bytes = P * es;
  const Range rg = block_range(row_bytes, kW);

  // tile t -> ring slot: 16-byte chunks from each row's aligned-down start,
  // as many as reach the tile's end (src-size 0 reads nothing)
  const uintptr_t theta_floor = reinterpret_cast<uintptr_t>(theta) & ~uintptr_t(15);
  auto load = [&](int64_t t, int slot) {
    const uint32_t dst = smem_u32(ring + slot * stage);
    const int64_t begin = rg.first + t * rg.width;
    const int64_t end = begin + rg.width < rg.last ? begin + rg.width : rg.last;
    for (int e = tid; e < n * kChunks; e += nthreads) {
      const int r = e / kChunks, m = e % kChunks;
      const unsigned char* row = reinterpret_cast<const unsigned char*>(theta + (int64_t)r * P);
      int bytes;
      const unsigned char* src;
      if constexpr (kVec) {  // the tile starts on the grid and ends on it
        src = row + begin + 16 * m;
        bytes = begin + 16 * m < end ? 16 : 0;
      } else {
        const uintptr_t at = reinterpret_cast<uintptr_t>(row);
        const uintptr_t chunk = ((at + begin) & ~uintptr_t(15)) + 16 * m;
        const uintptr_t stop = at + end;
        bytes = chunk >= stop ? 0 : stop - chunk < 16 ? (int)(stop - chunk) : 16;
        src = reinterpret_cast<const unsigned char*>(chunk);
      }
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst + r * (kW + 16) + 16 * m),
                   "l"(bytes ? reinterpret_cast<uintptr_t>(src) : theta_floor), "r"(bytes)
                   : "memory");
    }
  };

  const int ahead = stages - 1;
  for (int s = 0; s < ahead; ++s) {
    if (s < rg.n_tiles) load(s, s);
    cp_commit();
  }
  // the atoms, while the first tiles' copies are in flight
  for (int e = tid; e < Lp; e += nthreads) s_g[e] = e < L ? gammas[e] : 0.f;
  for (int e = tid; e < Lp * n; e += nthreads) {
    const int i = e / Lp, l = e % Lp;
    const int r = perms[(int64_t)(l < L ? l : L - 1) * n + i];  // past L: a repeat, not added
    const int shift =
        kVec ? 0 : (int)((reinterpret_cast<uintptr_t>(theta + (int64_t)r * P) & 15) / es);
    s_src[e] = r * kRow + shift;
  }

  int slot = 0;  // ring slot of tile t; tile t + ahead goes to the slot before it
  for (int64_t t = 0; t < rg.n_tiles; ++t) {
    __syncthreads();  // the slot of tile t - 1 is consumed (and the atoms staged)
    if (t + ahead < rg.n_tiles) load(t + ahead, slot == 0 ? stages - 1 : slot - 1);
    cp_commit();
    cp_wait(ahead);  // tile t has landed
    __syncthreads();
    const T* X = reinterpret_cast<const T*>(ring + slot * stage);
    slot = slot + 1 == stages ? 0 : slot + 1;
    const int64_t begin = rg.first + t * rg.width;
    const int64_t c0 = begin / es;  // the tile's first column, and its columns
    const int64_t cols = (rg.width < rg.last - begin ? rg.width : rg.last - begin) / es;
    if constexpr (kVec) {
      constexpr int N = 16 / es;             // elements of a vector
      constexpr int R = kW / 16;             // vectors of a staged row
      constexpr int LR = R >= 8 ? 8 : R;     // lanes a row (a quarter warp: 128 bytes of it)
      constexpr int VP = R / LR;             // vectors a lane
      constexpr int U = 8 / VP;              // atoms whose reads are in flight at once
      for (int e = tid; e < n * LR; e += nthreads) {
        const int i = e / LR, q = e % LR;
        if (q * N >= cols) continue;  // past the tile's last column
        float acc[VP][N];
#pragma unroll
        for (int k = 0; k < VP; ++k)
#pragma unroll
          for (int c = 0; c < N; ++c) acc[k][c] = 0.f;
        const int* row_src = s_src + i * Lp;
#pragma unroll 2
        for (int l0 = 0; l0 < L; l0 += U) {
          // U atoms' offsets and weights in 16-byte reads, then every data
          // read, then the adds in order (atoms past L read a repeated
          // row and are not added)
          int off[U];
          float g[U];
          read_atoms<U>(off, g, row_src + l0, s_g + l0);
          float4 x[U][VP];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int k = 0; k < VP; ++k)
              x[u][k] = *reinterpret_cast<const float4*>(X + off[u] + (q + k * LR) * N);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool add = l0 + u < L;
#pragma unroll
            for (int k = 0; k < VP; ++k) {
              const float f[N] = {x[u][k].x, x[u][k].y, x[u][k].z, x[u][k].w};
#pragma unroll
              for (int c = 0; c < N; ++c) {
                const float sum = __fadd_rn(acc[k][c], __fmul_rn(g[u], f[c]));
                acc[k][c] = add ? sum : acc[k][c];
              }
            }
          }
        }
        T* dst = out + (int64_t)i * P + c0;
#pragma unroll
        for (int k = 0; k < VP; ++k) {
          const int c = (q + k * LR) * N;
          if (c < cols)  // stored once and not read back: streaming
            __stcs(reinterpret_cast<float4*>(dst + c),
                   make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]));
        }
      }
    } else {
      constexpr int W = kW / es;            // columns a staged row holds
      constexpr int LR = W >= 32 ? 32 : W;  // lanes a row
      constexpr int EP = W / LR;            // elements a lane
      constexpr int U = EP >= 4 ? 4 : 8;    // atoms whose reads are in flight at once
      for (int e = tid; e < n * LR; e += nthreads) {
        const int i = e / LR, q = e % LR;
        if (q >= cols) continue;  // past the tile's last column
        float acc[EP];
#pragma unroll
        for (int k = 0; k < EP; ++k) acc[k] = 0.f;
        const int* row_src = s_src + i * Lp;
#pragma unroll 2
        for (int l0 = 0; l0 < L; l0 += U) {
          int off[U];
          float g[U];
          read_atoms<U>(off, g, row_src + l0, s_g + l0);
          float x[U][EP];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int k = 0; k < EP; ++k) x[u][k] = X[off[u] + q + k * LR];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool add = l0 + u < L;
#pragma unroll
            for (int k = 0; k < EP; ++k) {
              const float sum = __fadd_rn(acc[k], __fmul_rn(g[u], x[u][k]));
              acc[k] = add ? sum : acc[k];
            }
          }
        }
        T* dst = out + (int64_t)i * P + c0 + q;
#pragma unroll
        for (int k = 0; k < EP; ++k)
          if (q + k * LR < cols) dst[k * LR] = acc[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// l2 gather: one output row and column chunk a block (large n)
// ---------------------------------------------------------------------------

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
gather_scalar(const T* __restrict__ theta, const float* __restrict__ gammas,
              const int* __restrict__ perms, T* __restrict__ out, int n, int64_t P, int L) {
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
gather_vec(const T* __restrict__ theta, const float* __restrict__ gammas,
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

// ---------------------------------------------------------------------------
// host side: the design by shape, the persistent grid, the launch
// ---------------------------------------------------------------------------

enum Design { kStaged = 0, kGather = 1 };

struct Plan {
  Design design = kGather;
  int kw = 0;      // bytes of a tile row (staged)
  int stages = 0;  // ring stages (staged)
};

// The kernel for n rows and L atoms of es-byte elements, given the opt-in
// shared memory of a block: float32 staged with the widest tile row of
// 512, 256, 128 and 64 bytes that leaves room for two ring stages, else
// 64 bytes with one; the l2 gather where not even that fits, and for
// bfloat16 (where the staged kernel, tried, ran ~5% slower than the l2
// gather at n = 100, P = 50896 on an H100: PERF.md).
Plan plan(int n, int L, int es, int max_smem) {
  Plan p;
  const size_t atoms = atoms_bytes(n, L);
  if (es != 4 || atoms + stage_bytes(n, 64) > (size_t)max_smem) return p;
  const size_t avail = max_smem - atoms;
  p.design = kStaged;
  for (int kw : {512, 256, 128, 64}) {
    const size_t stages = avail / stage_bytes(n, kw);
    if (stages >= 2 || kw == 64) {
      p.kw = kw;
      p.stages = (int)(stages < (size_t)kMaxStages ? stages : kMaxStages);
      break;
    }
  }
  return p;
}

// schedule_staged<kW, kVec> for kW = 512, 256, 128, 64 and kVec = true, false
const void* staged_kernel(int kw, bool vec) {
  switch (kw) {
    case 512: return vec ? (const void*)schedule_staged<512, true>
                         : (const void*)schedule_staged<512, false>;
    case 256: return vec ? (const void*)schedule_staged<256, true>
                         : (const void*)schedule_staged<256, false>;
    case 128: return vec ? (const void*)schedule_staged<128, true>
                         : (const void*)schedule_staged<128, false>;
    default: return vec ? (const void*)schedule_staged<64, true>
                        : (const void*)schedule_staged<64, false>;
  }
}

struct DeviceInfo {
  int sms = 0;
  int max_smem = 0;  // opt-in shared memory per block
  // the last occupancy query of each staged kernel: its shared bytes,
  // threads and answer
  size_t smem[8] = {};
  int threads[8] = {};
  int blocks[8] = {};
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
    for (int kw : {512, 256, 128, 64})
      for (bool vec : {true, false})
        if ((err = cudaFuncSetAttribute(staged_kernel(kw, vec),
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem)) !=
            cudaSuccess)
          return (int)err;
    d.max_smem = max_smem;
    d.sms = sms;
  }
  *out = &d;
  return 0;
}

template <typename T>
int launch(const void* theta, const void* gammas, const void* perms, void* out, int n,
           int64_t P, int L, int vectorized, void* stream) {
  DeviceInfo* d = nullptr;
  const int status = device_info(&d);
  if (status != 0) return status;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* th = static_cast<const T*>(theta);
  const float* g = static_cast<const float*>(gammas);
  const int* pm = static_cast<const int*>(perms);
  T* o = static_cast<T*>(out);
  const int es = (int)sizeof(T);
  const Plan p = plan(n, L, es, d->max_smem);
  if (p.design == kStaged) {  // float32
    const int64_t row_bytes = P * es;
    const size_t smem = atoms_bytes(n, L) + p.stages * stage_bytes(n, p.kw);
    const void* kernel = staged_kernel(p.kw, vectorized != 0);
    // threads: the fewest rounds of at most kMaxThreads over a tile's
    // tasks (an output row's lanes), the tasks spread evenly over them
    const int lanes = vectorized ? (p.kw / 16 >= 8 ? 8 : p.kw / 16)
                                 : (p.kw / es >= 32 ? 32 : p.kw / es);
    const int tasks = n * lanes;
    const int rounds = (tasks + kMaxThreads - 1) / kMaxThreads;
    const int threads = ((tasks + rounds - 1) / rounds + 31) / 32 * 32;
    // persistent grid: as many blocks as fit on the card at once (one an
    // SM unless the tile is small), at most one a tile's width of a row
    const int slot =
        (p.kw == 512 ? 0 : p.kw == 256 ? 2 : p.kw == 128 ? 4 : 6) + (vectorized ? 0 : 1);
    if (d->smem[slot] != smem || d->threads[slot] != threads) {
      int blocks = 0;
      const cudaError_t err =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
      if (err != cudaSuccess) return (int)err;
      d->blocks[slot] = blocks > 0 ? blocks : 1;
      d->smem[slot] = smem;
      d->threads[slot] = threads;
    }
    const int64_t full = (int64_t)d->blocks[slot] * d->sms;
    const int64_t wide = (row_bytes + p.kw - 1) / p.kw;
    const unsigned grid = (unsigned)(wide < full ? wide : full);
    int stages = p.stages;
    void* args[] = {&th, &g, &pm, &o, &n, &P, &L, &stages};
    const cudaError_t err = cudaLaunchKernel(kernel, grid, threads, args, smem, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    const int64_t span = vectorized ? (int64_t)kThreads * kVecUnroll * Vec16<T>::N
                                    : (int64_t)kThreads * kScalarUnroll;
    const int64_t n_chunks = (P + span - 1) / span;
    const dim3 grid((unsigned)n, (unsigned)(n_chunks < kMaxGridY ? n_chunks : kMaxGridY));
    if (vectorized) {
      gather_vec<T><<<grid, kThreads, 0, s>>>(th, g, pm, o, n, P, L);
    } else {
      gather_scalar<T><<<grid, kThreads, 0, s>>>(th, g, pm, o, n, P, L);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// theta, out: (n, P) row-major; gammas: (L,) float32; perms: (L, n) int32
// with every entry in [0, n); vectorized: P sizeof(T) % 16 == 0 and
// theta, out 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int gossip_schedule_f32(const void* theta, const void* gammas, const void* perms,
                                   void* out, int n, int64_t P, int L, int vectorized,
                                   void* stream) {
  return launch<float>(theta, gammas, perms, out, n, P, L, vectorized, stream);
}

extern "C" int gossip_schedule_bf16(const void* theta, const void* gammas, const void* perms,
                                    void* out, int n, int64_t P, int L, int vectorized,
                                    void* stream) {
  return launch<bf16>(theta, gammas, perms, out, n, P, L, vectorized, stream);
}

// The kernel gossip_schedule_<dtype> runs for n rows, L atoms and
// elements of elem_bytes on the current device: 0 the staged kernel (the
// bytes of its tile rows and its ring stages in *tile_bytes, *stages), 1
// the l2 gather kernel (both 0); or -(cudaError_t).
extern "C" int gossip_schedule_design(int n, int L, int elem_bytes, int* tile_bytes,
                                      int* stages) {
  DeviceInfo* d = nullptr;
  const int status = device_info(&d);
  if (status != 0) return -status;
  const Plan p = plan(n, L, elem_bytes, d->max_smem);
  *tile_bytes = p.kw;
  *stages = p.stages;
  return (int)p.design;
}
