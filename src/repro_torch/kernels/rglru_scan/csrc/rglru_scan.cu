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
// its grid runs in order. Here blocks run in no order, and a block that
// covered all of S could not keep its a and b on chip (1 MB for 32
// features at S = 4096), so it would read them twice. Instead time is
// split ACROSS blocks and the state is carried between them by a
// single-pass chained scan with decoupled look-back, so a and b leave
// device memory once:
//   - a tile is (batch b, 32 features, kTile = 256 time steps), one
//     512-thread block each. Tiles are handed out in order by an atomic
//     ticket, time slowest (ticket = k * chains + chain, chain = (b,
//     feature block)), so a tile's predecessors in time all hold tickets
//     before it and a block never waits on one that is not running.
//   - the block copies the tile's a and b into shared memory once with
//     16-byte cp.async, so no register holds data in flight. Where every
//     step's features start on the 16-byte grid (D sizeof(T) % 16 == 0,
//     aligned pointers) a thread's copies step by whole rows; otherwise
//     each step is copied from its address rounded down to 16 bytes and
//     sits shift bytes into its staged row, so any D takes 16-byte copies.
//   - warp w takes time slice w (16 steps), lane f feature f; each thread
//     composes its 16 steps from h = 0: A = prod a_t, H = the end state.
//     Warp 0 turns the slices' (A, H) into each slice's exclusive prefix
//     and the tile's aggregate.
//   - warp 0 carries the tile's state, so that it never depends on
//     timing: every kOrigin-th time tile of a chain is an origin, and a
//     tile starts from the end state of the last origin before it. It
//     publishes its aggregate (flag 1; the first tile of a chain
//     publishes its end state at once, flag 2), waits until the tiles
//     between the origin and itself have published their aggregates and
//     the origin its end state (lane c watches tile k - 1 - c), folds
//     those aggregates, nearest first (each lane its feature), onto the
//     origin's end state, and so obtains the incoming state; an origin
//     publishes its own end state (flag 2). Values are written, fenced,
//     then flagged with a release store; readers acquire the flag and
//     read the values from L2 (ld.cg). Which values a tile folds, and in
//     which order, is fixed by its index alone, so two launches on the
//     same inputs give the same bits. The origins form a chain one L2
//     round trip a hop, ceil(S / (kTile kOrigin)) hops; the tiles
//     between them wait only on aggregates, which are published as soon
//     as a tile's own pass ends.
//   - every thread rescans its 16 steps from the shared copy, starting
//     from its slice's incoming state, and writes h.
// Tile shape, from scripts/kernel_ab.py scan-floor on an H100: 256 steps
// beat 128 (half the look-backs; the look-back is ~15% of the kernel);
// 64- or 128-feature steps ran slower than 32. The kernel is bound by
// instruction issue more than by bytes: keep the per-element work (the
// aligned path's copies and shared reads) lean. kGroups > 1 splits a
// tile into 32-feature groups with a flag each (kept for those A/Bs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kLanes = 32;                 // features of a group (a warp's lanes)
constexpr int kGroups = 1;                 // feature groups of a tile
constexpr int kFeat = kLanes * kGroups;    // features of a tile
constexpr int kWarps = 16;
constexpr int kSlices = kWarps / kGroups;  // time slices of a tile
constexpr int kSteps = 16;                 // time steps a thread
constexpr int kTile = kSlices * kSteps;    // time steps of a tile
constexpr int kThreads = kLanes * kWarps;
constexpr int kValues = 3 * kLanes;        // a group's workspace floats: A, H, end state
constexpr int kPad = 16;                   // a staged step's room for a shift
constexpr int kOrigin = 8;                 // time tiles between two origins, <= kLanes
static_assert(kOrigin >= 1 && kOrigin <= kLanes, "a tile folds at most kLanes - 1 aggregates");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// a warp: each lane has written its feature's values of the group; make
// them visible, then flag the group
__device__ __forceinline__ void publish(int* flag, int status, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) store_release(flag, status);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bytes of a staged time step: the tile's features and room for a shift.
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return kFeat * (int)sizeof(T) + kPad;
}

// Copy time steps [row0, row0 + t_valid) of features [d0, min(d0 + kFeat,
// D)) of x (row stride D) into dst, step by step (src-size 0 reads
// nothing). kAligned (every step's features start on the 16-byte grid):
// thread j copies chunk j % C of steps j / C, j / C + kThreads / C, ...,
// its source pointer stepping by whole rows. Otherwise 16-byte chunks
// from each step's address rounded down to 16 bytes, as many as its data
// needs: a step starting shift bytes past the grid sits shift bytes into
// its staged row.
template <typename T, bool kAligned>
__device__ __forceinline__ void stage(unsigned char* dst, const T* x, int64_t row0, int t_valid,
                                      int D, int d0) {
  constexpr int kRow = row_bytes<T>();
  const int feats = min(kFeat, D - d0);
  if constexpr (kAligned) {
    constexpr int C = kFeat * (int)sizeof(T) / 16;  // chunks a step
    constexpr int kStride = kThreads / C;           // steps between a thread's copies
    const int m = threadIdx.x % C;
    int t = threadIdx.x / C;
    const int bytes = m * 16 < feats * (int)sizeof(T) ? 16 : 0;  // D % (16 / sizeof(T)) == 0
    const T* src = x + (row0 + t) * D + d0 + m * (16 / (int)sizeof(T));
    uint32_t d = smem_u32(dst + t * kRow + 16 * m);
#pragma unroll 4
    for (; t < kTile; t += kStride) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(t < t_valid && bytes ? src : x), "r"(t < t_valid ? bytes : 0)
                   : "memory");
      src += (int64_t)kStride * D;
      d += kStride * kRow;
    }
  } else {
    constexpr int kChunks = kRow / 16;
    const uintptr_t floor16 = reinterpret_cast<uintptr_t>(x) & ~uintptr_t(15);
    for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
      const int t = e / kChunks, m = e % kChunks;
      const uintptr_t row = reinterpret_cast<uintptr_t>(x + (row0 + t) * D + d0);
      const uintptr_t chunk = (row & ~uintptr_t(15)) + 16 * m;
      const uintptr_t stop = row + feats * sizeof(T);  // the step's data ends here
      const int bytes =
          t >= t_valid || chunk >= stop ? 0 : stop - chunk < 16 ? (int)(stop - chunk) : 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(dst + t * kRow + 16 * m)),
                   "l"(bytes ? chunk : floor16), "r"(bytes)
                   : "memory");
    }
  }
}

// kAligned: D sizeof(T) % 16 == 0 and a, b 16-byte aligned.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h, int S,
                  int D, int chains, int blocks_d, int* __restrict__ counter,
                  int* __restrict__ flags, float* __restrict__ values) {
  constexpr int es = (int)sizeof(T);
  constexpr int kRow = row_bytes<T>();
  extern __shared__ __align__(16) unsigned char s_a[];  // a's staged steps, then b's
  unsigned char* s_b = s_a + kTile * kRow;
  __shared__ int s_tile;
  __shared__ float s_A[kSlices][kFeat];  // each slice's composition from h = 0
  __shared__ float s_H[kSlices][kFeat];
  __shared__ float s_in[kSlices][kFeat];  // each slice's incoming state
  const int lane = threadIdx.x % kLanes;
  const int w = threadIdx.x / kLanes;
  const int g = w % kGroups;   // this warp's feature group
  const int sl = w / kGroups;  // and time slice
  const int f = g * kLanes + lane;  // this thread's feature in the tile
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const int k = tile / chains;  // time tile
  const int chain = tile % chains;
  const int d0 = (chain % blocks_d) * kFeat;
  const int64_t row0 = (int64_t)(chain / blocks_d) * S + (int64_t)k * kTile;
  const int t_valid = min(kTile, S - k * kTile);
  stage<T, kAligned>(s_a, a, row0, t_valid, D, d0);
  stage<T, kAligned>(s_b, b, row0, t_valid, D, d0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // this thread's feature in staged step ts + i: byte offset from the
  // slice's first step, and (unaligned) where each step's data starts
  const int ts = sl * kSteps;  // this slice's first step in the tile
  const unsigned char* pa = s_a + ts * kRow + f * es;
  const unsigned char* pb = s_b + ts * kRow + f * es;
  uint32_t sha = 0, shb = 0;  // shift of step ts + i, advanced by D sizeof(T) a step
  const uint32_t dstep = (uint32_t)D * es;
  if constexpr (!kAligned) {
    const uint32_t first = (uint32_t)((row0 + ts) * D + d0) * es;
    sha = ((uint32_t)reinterpret_cast<uintptr_t>(a) + first) & 15u;
    shb = ((uint32_t)reinterpret_cast<uintptr_t>(b) + first) & 15u;
  }
  auto at = [&](const unsigned char* p, uint32_t shift, int i) {
    return to_f32(*reinterpret_cast<const T*>(p + i * kRow + shift));
  };
  const int steps = min(kSteps, t_valid - ts);  // may be <= 0
  float A = 1.f, H = 0.f;
  {
    uint32_t ra = sha, rb = shb;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i >= steps) break;
      const float x = at(pa, ra, i);
      H = fmaf(x, H, at(pb, rb, i));
      A *= x;
      if constexpr (!kAligned) ra = (ra + dstep) & 15u, rb = (rb + dstep) & 15u;
    }
  }
  s_A[sl][f] = A;
  s_H[sl][f] = H;
  __syncthreads();

  if (sl == 0) {  // one warp a feature group carries its state
    // exclusive prefix over the slices; (eA, eH) ends as the group's aggregate
    float eA = 1.f, eH = 0.f;
#pragma unroll
    for (int c = 0; c < kSlices; ++c) {
      const float cA = s_A[c][f], cH = s_H[c][f];
      s_A[c][f] = eA;
      s_H[c][f] = eH;
      eH = fmaf(cA, eH, cH);
      eA *= cA;
    }
    const int me = tile * kGroups + g;  // this group's flag and values
    float* mine = values + (int64_t)me * kValues;
    float h_in = 0.f;
    if (k == 0) {
      __stcg(mine + 2 * kLanes + lane, eH);
      publish(flags + me, 2, lane);
    } else {
      __stcg(mine + lane, eA);
      __stcg(mine + kLanes + lane, eH);
      publish(flags + me, 1, lane);
      // the origin, and the aggregates of tiles k - 1 .. origin + 1 between
      const int origin = (k - 1) / kOrigin * kOrigin;
      const int m = k - 1 - origin;
      if (lane <= m) {  // lane c watches time tile k - 1 - c; lane m the origin's end state
        const int* fp = flags + ((k - 1 - lane) * chains + chain) * kGroups + g;
        const int want = lane == m ? 2 : 1;
        while (load_acquire(fp) < want) __nanosleep(64);
      }
      __syncwarp();
      __threadfence();
      float gA = 1.f, gH = 0.f;  // the tiles folded so far, composed
      for (int c = 0; c < m; ++c) {
        const float* u = values + ((int64_t)((k - 1 - c) * chains + chain) * kGroups + g) * kValues;
        const float jA = __ldcg(u + lane), jH = __ldcg(u + kLanes + lane);
        gH = fmaf(gA, jH, gH);
        gA *= jA;
      }
      const float* u = values + ((int64_t)(origin * chains + chain) * kGroups + g) * kValues;
      h_in = fmaf(gA, __ldcg(u + 2 * kLanes + lane), gH);
      if (k % kOrigin == 0) {
        __stcg(mine + 2 * kLanes + lane, fmaf(eA, h_in, eH));
        publish(flags + me, 2, lane);
      }
    }
#pragma unroll
    for (int c = 0; c < kSlices; ++c) s_in[c][f] = fmaf(s_A[c][f], h_in, s_H[c][f]);
  }
  __syncthreads();

  float hc = s_in[sl][f];
  T* out = h + (row0 + ts) * D + d0 + f;
  const bool active = d0 + f < D;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (i >= steps) break;
    hc = fmaf(at(pa, sha, i), hc, at(pb, shb, i));
    if (active) *out = from_f32<T>(hc);
    out += D;
    if constexpr (!kAligned) sha = (sha + dstep) & 15u, shb = (shb + dstep) & 15u;
  }
}

struct Tiles {
  int64_t blocks_d, chains, n;
};

Tiles tiles(int B, int S, int D) {
  Tiles t;
  t.blocks_d = (D + kFeat - 1) / kFeat;
  t.chains = B * t.blocks_d;
  t.n = t.chains * ((S + kTile - 1) / kTile);
  return t;
}

constexpr int kMaxDevices = 64;

// the kernels' shared bytes (the tile's a and b), allowed once per device
template <typename T>
int smem_bytes(size_t* bytes) {
  static bool allowed[kMaxDevices] = {};
  *bytes = 2 * (size_t)kTile * row_bytes<T>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    for (const void* k : {(const void*)rglru_scan_kernel<T, true>,
                          (const void*)rglru_scan_kernel<T, false>})
      if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)*bytes)) != cudaSuccess)
        return (int)err;
    allowed[dev] = true;
  }
  return 0;
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int D, void* zeroed,
           void* scratch, void* stream) {
  const Tiles t = tiles(B, S, D);
  if (t.n >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const int status = smem_bytes<T>(&bytes);
  if (status != 0) return status;
  int* counter = static_cast<int*>(zeroed);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  const bool aligned = ((int64_t)D * (int64_t)sizeof(T)) % 16 == 0 && addr % 16 == 0;
  auto kernel = aligned ? rglru_scan_kernel<T, true> : rglru_scan_kernel<T, false>;
  kernel<<<(unsigned)t.n, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), S, D,
      (int)t.chains, (int)t.blocks_d, counter, counter + 1, static_cast<float*>(scratch));
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, D), row-major, one dtype; B * ceil(D / 32) * ceil(S /
// 256) tiles below 2^31 (else cudaErrorInvalidValue). zeroed, scratch: the
// workspace of rglru_scan_workspace(B, S, D), zeroed's bytes set to 0 on
// the launch's stream before it. Returns the launch's cudaError_t.
extern "C" int rglru_scan_f32(const void* a, const void* b, void* h, int B, int S, int D,
                              void* zeroed, void* scratch, void* stream) {
  return launch<float>(a, b, h, B, S, D, zeroed, scratch, stream);
}

extern "C" int rglru_scan_bf16(const void* a, const void* b, void* h, int B, int S, int D,
                               void* zeroed, void* scratch, void* stream) {
  return launch<__nv_bfloat16>(a, b, h, B, S, D, zeroed, scratch, stream);
}

// The workspace of a (B, S, D) scan: *zeroed_bytes to be zeroed (the
// ticket counter and a flag a tile's feature group) and *scratch_bytes
// not (the groups' published values). Returns the time steps of a tile.
extern "C" int rglru_scan_workspace(int B, int S, int D, int64_t* zeroed_bytes,
                                    int64_t* scratch_bytes) {
  const Tiles t = tiles(B, S, D);
  *zeroed_bytes = (t.n * kGroups + 1) * (int64_t)sizeof(int);
  *scratch_bytes = t.n * kGroups * kValues * (int64_t)sizeof(float);
  return kTile;
}
