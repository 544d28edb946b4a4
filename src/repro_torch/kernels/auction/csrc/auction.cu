// Device auction LMO: an eps-scaling forward(-reverse) auction in float64,
// one solve per launch, for sm_90a.
//
// Replaces: the reference's compiled engine `_compiled_core`
// (src/repro/core/assignment_jit.py:184), a `lax.while_loop` with no
// Pallas kernel: the whole solve is one device computation there, and
// one launch of this kernel here. A loop of PyTorch operations would
// read "anyone unassigned?" and "gap certified?" back to the host at
// every round, thousands of times a Frank-Wolfe gradient.
//
// What bounds it: not the card's rates. One block runs the whole ladder,
// serially: each Gauss-Seidel bid reads one row of the benefit matrix
// (8n bytes, from L2 while n*n*8 fits in its 50 MB) and the prices, and
// ends in reductions (and, above n = 512, block barriers), so a solve
// costs its bid count times a bid's latency (0.8-2.5 us measured). The
// least the card could take is one pass over the float64 matrix per
// phase at the memory rate.
//
// Design (the plain version is ../ref.py; this kernel repeats its
// arithmetic operation for operation, so both return the same
// assignment):
// - one persistent block of 512 threads; prices, profits, col_of_row and
//   owner in shared memory while 24 n bytes fit (n <= 9386), in the
//   caller's device workspace above that;
// - a prepare pass validates the cost (NaN / -inf, +inf forbidden pairs,
//   fully forbidden rows or columns), substitutes the finite sentinel,
//   and snaps the cost onto the 1e-12-relative grid into the benefit
//   buffer (which may be the cost buffer itself);
// - a Jacobi round takes the first min(n, 64) unassigned rows (an
//   ordered compaction by warp ballots), gives a warp to each bidder for
//   its best / smallest-index argmax / second best, and resolves the
//   conflicts without atomics by an O(64^2) pass over (column, bid, row)
//   in shared memory: highest bid wins, ties to the largest row;
// - a Gauss-Seidel bid, the evicted row bidding next, is one warp's
//   (best, argmax, second) reduction over the row up to n = 512 (no
//   block barrier per bid), a block-wide one above (a warp's n / 32
//   serial row loads then cost more than the block's three barriers);
// - the phase check sums the per-row slack in a fixed pairwise order
//   (`tree_sum` in ref.py) for the duality-gap certificate;
// - the rescue of a stalled phase, the floating-point floor and the
//   round cap `max_iters` are the reference's; a solve that ends without
//   converging reports it in `stats` and the host wrapper raises.
// Max and min reductions are exact in any order and no product here is
// followed by an add the compiler could fuse (the one such expression,
// the sentinel, is written with explicit round-to-nearest intrinsics),
// so every value is the plain version's.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBucket = 64;
constexpr int kMaxOuter = 256;
constexpr int kReverseRoundCap = 64;
// largest n whose Gauss-Seidel bids one warp makes (measured: faster than
// the block-wide bid at n = 128 and 512, slower at 1024 and 2048)
constexpr int kWarpBidMaxN = 512;
constexpr double kFpFloor = 3.552713678800501e-15;  // 2^-48
constexpr double kEpsScaling = 6.0;
constexpr double kTiny = 2.2250738585072014e-308;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory for prices, pi (float64) and col, owner (int32)
constexpr size_t kSmemStateMax = 220 * 1024;

// the stats vector, in ref.py's STATS order
enum { kBad, kBlocked, kNForb, kTied, kConverged, kPhases, kRounds, kRebid, kOuter, kNStats };

struct Best {
  double best;
  int idx;
  double second;
};

__device__ __forceinline__ Best best_init() { return {-INFINITY, INT_MAX, -INFINITY}; }

// elements arrive in increasing j within one thread
__device__ __forceinline__ void best_push(Best& b, double v, int j) {
  if (v > b.best) {
    b.second = b.best;
    b.best = v;
    b.idx = j;
  } else if (v > b.second) {
    b.second = v;
  }
}

// (max, smallest index reaching it, max over the other indices) of two
// disjoint sets; the same whichever comes first
__device__ __forceinline__ Best best_merge(Best a, Best b) {
  if (b.best > a.best || (b.best == a.best && b.idx < a.idx)) {
    return {b.best, b.idx, a.best > b.second ? a.best : b.second};
  }
  return {a.best, a.idx, b.best > a.second ? b.best : a.second};
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.best = __shfl_xor_sync(kFull, b.best, off);
    o.idx = __shfl_xor_sync(kFull, b.idx, off);
    o.second = __shfl_xor_sync(kFull, b.second, off);
    b = best_merge(b, o);
  }
  return b;
}

__device__ __forceinline__ double dmax(double a, double b) { return a > b ? a : b; }
__device__ __forceinline__ double dmin(double a, double b) { return a < b ? a : b; }

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = dmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = dmin(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Block reductions: every thread gets the result. Each ends with a
// barrier, so its shared slots are free again when it returns.
__device__ double block_max(double v, double* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = red[0];
  for (int w = 1; w < kWarps; ++w) r = dmax(r, red[w]);
  __syncthreads();
  return r;
}

__device__ double block_min(double v, double* red) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = red[0];
  for (int w = 1; w < kWarps; ++w) r = dmin(r, red[w]);
  __syncthreads();
  return r;
}

__device__ long long block_sum(long long v, long long* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = 0;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

__device__ int block_min_int(int v, int* red) {
  v = warp_min_int(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < kWarps; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

__device__ Best block_best(Best b, Best* red) {
  b = warp_best(b);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = b;
  __syncthreads();
  Best r = red[0];
  for (int w = 1; w < kWarps; ++w) r = best_merge(r, red[w]);
  __syncthreads();
  return r;
}

// The first min(#negative, kBucket) indices i with a[i] < 0, in
// increasing order, into out; returns how many.
__device__ int first_negative(const int* a, int n, int* out, int* warp_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  int cnt = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    cnt += __popc(__ballot_sync(kFull, i < hi && a[i] < 0));
  }
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  int off = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? warp_cnt[w] : 0;
    total += warp_cnt[w];
  }
  for (int base = lo; base < hi && off < kBucket; base += 32) {
    const int i = base + lane;
    const bool f = i < hi && a[i] < 0;
    const unsigned m = __ballot_sync(kFull, f);
    const int pos = off + __popc(m & ((1u << lane) - 1u));
    if (f && pos < kBucket) out[pos] = i;
    off += __popc(m);
  }
  __syncthreads();
  return min(total, kBucket);
}

// Block-uniform control state: written by thread 0 between barriers.
struct Ctl {
  double eps, eps_run, s, budget, bids, spread, eps_final, gap_tol;
  int n_un, rounds, phases, outer, rebid, last, done, phase_rounds;
};

__global__ void __launch_bounds__(kThreads, 1)
auction_kernel(const double* __restrict__ cost, double* benefit, const double* warm_prices,
               const int* warm_col, double warm_scale, int have_warm, double rel_grid,
               double s0, int forward_reverse, int validate, int gs_threshold, int max_iters,
               int n, double* prices_out, int* col_out, long long* stats, double* work_f,
               int* work_i, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Ctl c;
  __shared__ Best red_best[kWarps];
  __shared__ double red_d[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ long long red_l[kWarps];
  __shared__ int warp_cnt[kWarps];
  __shared__ int sel[kBucket];
  __shared__ int bj[kBucket];
  __shared__ double bval[kBucket];
  __shared__ double bsec[kBucket];
  __shared__ int bwin[kBucket];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nn = (size_t)n * n;
  const int N = n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
  double *prices, *pi;
  int *col, *owner;
  if (use_smem) {
    prices = reinterpret_cast<double*>(smem_raw);
    pi = prices + n;
    col = reinterpret_cast<int*>(pi + n);
    owner = col + n;
  } else {
    prices = work_f;
    pi = work_f + n;
    col = work_i;
    owner = work_i + n;
  }
  double* slack = work_f + 2 * (size_t)n;
  double* maxprof = slack + n;
  double* tree = maxprof + n;  // N entries
  const bool fr = forward_reverse != 0;
  const int bucket = min(n, kBucket);

  // ---- prepare: validation, forbidden sentinel, grid snap ----
  bool bad = false;
  long long nf = 0;
  double hi = -INFINITY, lo = INFINITY, sc = 0.0;
  for (size_t e = tid; e < nn; e += kThreads) {
    const double x = cost[e];
    if (validate) {
      if (isnan(x) || x == -INFINITY) bad = true;
      if (x == INFINITY) {
        ++nf;
      } else {
        hi = dmax(hi, x);
        lo = dmin(lo, x);
        sc = dmax(sc, fabs(x));
      }
    } else {
      sc = dmax(sc, fabs(x));
    }
  }
  const long long n_bad = block_sum(bad ? 1 : 0, red_l);
  nf = block_sum(nf, red_l);
  hi = block_max(hi, red_d);
  lo = block_min(lo, red_d);
  sc = block_max(sc, red_d);
  long long n_blocked = 0;
  if (validate && nf > 0) {
    long long b = 0;
    for (int i = warp; i < n; i += kWarps) {  // fully forbidden rows
      long long k = 0;
      for (int j = lane; j < n; j += 32) k += cost[(size_t)i * n + j] == INFINITY;
      if (warp_sum(k) == n && lane == 0) ++b;
    }
    for (int j = tid; j < n; j += kThreads) {  // fully forbidden columns
      int k = 0;
      for (int i = 0; i < n; ++i) k += cost[(size_t)i * n + j] == INFINITY;
      if (k == n) ++b;
    }
    n_blocked = block_sum(b, red_l);
  }
  // hi + n (hi - lo) + max(|hi|, 1), each operation rounded on its own
  const double sentinel =
      __dadd_rn(__dadd_rn(hi, __dmul_rn((double)n, hi - lo)), dmax(fabs(hi), 1.0));
  const double grid = sc * rel_grid;
  double bmax = -INFINITY, bmin = INFINITY;
  for (size_t e = tid; e < nn; e += kThreads) {
    const double x = cost[e];
    const double f = (validate && x == INFINITY) ? sentinel : x;
    const double b = -(grid > 0.0 ? rint(f / grid) * grid : f);
    benefit[e] = b;
    bmax = dmax(bmax, b);
    bmin = dmin(bmin, b);
  }
  bmax = block_max(bmax, red_d);
  bmin = block_min(bmin, red_d);  // its barrier also publishes benefit
  const double spread = bmax - bmin;
  const bool tied = spread <= 0.0;
  const double eps_final = dmax(grid, kTiny) / (double)(n + 1);

  // ---- warm start ----
  bool fin = true;
  double wmax = -INFINITY, wmin = INFINITY;
  if (have_warm) {
    for (int j = tid; j < n; j += kThreads) {
      const double w = warm_prices[j] * warm_scale;
      fin = fin && isfinite(w);
      wmax = dmax(wmax, w);
      wmin = dmin(wmin, w);
    }
  }
  const long long n_nonfinite = block_sum(fin ? 0 : 1, red_l);
  wmax = block_max(wmax, red_d);
  wmin = block_min(wmin, red_d);
  const bool warm_ok = have_warm && n_nonfinite == 0 && (wmax - wmin) <= 8.0 * spread;
  for (int j = tid; j < n; j += kThreads) {
    prices[j] = warm_ok ? warm_prices[j] * warm_scale : 0.0;
    col[j] = warm_ok ? warm_col[j] : -1;
    owner[j] = -1;
  }
  __syncthreads();
  long long un = 0;
  for (int i = tid; i < n; i += kThreads) {
    if (col[i] >= 0) owner[col[i]] = i;
    else ++un;
  }
  if (fr) {
    for (int i = warp; i < n; i += kWarps) {
      double m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = dmax(m, benefit[(size_t)i * n + j] - prices[j]);
      m = warp_max(m);
      if (lane == 0) pi[i] = m;
    }
  } else {
    for (int i = tid; i < n; i += kThreads) pi[i] = 0.0;
  }
  un = block_sum(un, red_l);
  double pmag = 0.0;
  for (int j = tid; j < n; j += kThreads) pmag = dmax(pmag, fabs(prices[j]));
  pmag = block_max(pmag, red_d);
  if (tid == 0) {
    const double eps0 = warm_ok ? INFINITY : dmax(spread / s0, eps_final);
    c.eps = eps0;
    c.eps_run = isinf(eps0) ? eps0 : dmax(eps0, pmag * kFpFloor);
    c.s = s0;
    c.budget = 8.0 * n + 2048.0;
    c.spread = spread;
    c.eps_final = eps_final;
    c.gap_tol = 0.5 * grid;
    c.n_un = (int)un;
    c.rounds = 0;
    c.phases = 0;
    c.outer = 0;
    c.rebid = n;
    c.done = tied || n_bad > 0 || n_blocked > 0;
  }
  __syncthreads();

  // ---- the ladder ----
  while (!c.done && c.outer < kMaxOuter && c.rounds < max_iters) {
    if (tid == 0) {
      c.bids = 0.0;
      c.phase_rounds = 0;
    }
    __syncthreads();
    // Jacobi rounds while many rows are unassigned
    while (c.n_un > gs_threshold && c.bids < c.budget && c.rounds < max_iters) {
      const double eps_run = c.eps_run;
      int nb = first_negative(col, n, sel, warp_cnt);
      for (int b = warp; b < nb; b += kWarps) {
        const double* row = benefit + (size_t)sel[b] * n;
        Best r = best_init();
        for (int j = lane; j < n; j += 32) best_push(r, row[j] - prices[j], j);
        r = warp_best(r);
        if (lane == 0) {
          bj[b] = r.idx;
          bval[b] = r.best + prices[r.idx] - r.second + eps_run;
          bsec[b] = r.second;
        }
      }
      __syncthreads();
      if (tid < nb) {
        const int j = bj[tid], row = sel[tid];
        const double bid = bval[tid];
        bool win = true;
        for (int b = 0; b < nb; ++b) {
          if (b != tid && bj[b] == j && (bval[b] > bid || (bval[b] == bid && sel[b] > row)))
            win = false;
        }
        bwin[tid] = win;
      }
      __syncthreads();
      if (tid < nb && bwin[tid]) {
        const int j = bj[tid], row = sel[tid];
        const int ev = owner[j];
        if (ev >= 0) col[ev] = -1;
        col[row] = j;
        owner[j] = row;
        prices[j] = bval[tid];
        if (fr) pi[row] = bsec[tid] - eps_run;
        atomicAdd(&c.n_un, (ev >= 0 ? 1 : 0) - 1);
      }
      __syncthreads();
      if (fr && eps_run > eps_final && c.phase_rounds < kReverseRoundCap) {
        // reverse round: the first unowned columns bid for rows
        nb = first_negative(owner, n, sel, warp_cnt);
        for (int b = warp; b < nb; b += kWarps) {
          const int j = sel[b];
          Best r = best_init();
          for (int i = lane; i < n; i += 32) best_push(r, benefit[(size_t)i * n + j] - pi[i], i);
          r = warp_best(r);
          if (lane == 0) {
            bj[b] = r.idx;
            bval[b] = r.best;
            bsec[b] = r.second;
          }
        }
        __syncthreads();
        if (tid < nb) {
          const int i = bj[tid], jc = sel[tid];
          const double offer = bval[tid];
          bool win = true;
          for (int b = 0; b < nb; ++b) {
            if (b != tid && bj[b] == i && (bval[b] > offer || (bval[b] == offer && sel[b] > jc)))
              win = false;
          }
          bwin[tid] = win;
        }
        __syncthreads();
        if (tid < nb && bwin[tid]) {
          const int i = bj[tid], j = sel[tid];
          const int old = col[i];
          if (old < 0) atomicAdd(&c.n_un, -1);
          prices[j] = dmin(prices[j], bsec[tid] - eps_run);
          if (old >= 0) owner[old] = -1;
          owner[j] = i;
          col[i] = j;
          pi[i] = benefit[(size_t)i * n + j] - prices[j];
        }
        __syncthreads();
      }
      if (tid == 0) {
        c.rounds += 1;
        c.bids += (double)bucket;
        c.phase_rounds += 1;
      }
      __syncthreads();
    }
    // Gauss-Seidel drain, following the eviction chain. Up to n = 512 one
    // warp bids (a warp reduction and __syncwarp, no block barrier per
    // bid) while the others wait at the barrier after the drain; above,
    // a warp's n / 32 serial row loads cost more than the block's
    // barriers, and the whole block bids. Both give the same values.
    if (n <= kWarpBidMaxN) {
      if (warp == 0) {
        int n_un = c.n_un, rounds = c.rounds, last = -1;
        double bids = c.bids;
        const double budget = c.budget, eps_run = c.eps_run;
        while (n_un > 0 && bids < budget && rounds < max_iters) {
          int i = last;
          if (i < 0) {  // the smallest unassigned row
            int m = INT_MAX;
            for (int k = lane; k < n; k += 32) {
              if (col[k] < 0) {
                m = k;
                break;
              }
            }
            i = warp_min_int(m);
          }
          const double* row = benefit + (size_t)i * n;
          Best r = best_init();
#pragma unroll 4
          for (int j = lane; j < n; j += 32) best_push(r, row[j] - prices[j], j);
          r = warp_best(r);
          int old = -1;
          if (lane == 0) {
            const int j = r.idx;
            prices[j] = prices[j] + ((r.best - r.second) + eps_run);
            old = owner[j];
            if (old >= 0) col[old] = -1;
            col[i] = j;
            owner[j] = i;
          }
          old = __shfl_sync(kFull, old, 0);
          __syncwarp();  // lane 0's writes are seen by the warp's next bid
          n_un += (old >= 0 ? 1 : 0) - 1;
          rounds += 1;
          bids += 1.0;
          last = old;
        }
        if (lane == 0) {
          c.n_un = n_un;
          c.rounds = rounds;
          c.bids = bids;
        }
      }
      __syncthreads();
    } else {
      if (tid == 0) c.last = -1;
      __syncthreads();
      while (c.n_un > 0 && c.bids < c.budget && c.rounds < max_iters) {
        int i = c.last;
        if (i < 0) {
          int m = INT_MAX;
          for (int k = tid; k < n; k += kThreads) if (col[k] < 0) m = min(m, k);
          i = block_min_int(m, red_i);
        }
        const double* row = benefit + (size_t)i * n;
        Best r = best_init();
        for (int j = tid; j < n; j += kThreads) best_push(r, row[j] - prices[j], j);
        r = block_best(r, red_best);
        if (tid == 0) {
          const int j = r.idx;
          prices[j] = prices[j] + ((r.best - r.second) + c.eps_run);
          const int old = owner[j];
          if (old >= 0) col[old] = -1;
          col[i] = j;
          owner[j] = i;
          c.n_un += (old >= 0 ? 1 : 0) - 1;
          c.rounds += 1;
          c.bids += 1.0;
          c.last = old;
        }
        __syncthreads();
      }
    }
    pmag = 0.0;
    for (int j = tid; j < n; j += kThreads) pmag = dmax(pmag, fabs(prices[j]));
    pmag = block_max(pmag, red_d);
    if (c.n_un > 0) {
      // the phase stalled: raise eps back, relax the factor, grow the budget
      if (tid == 0) {
        const double eps_new = dmin(c.eps * c.s, c.spread / kEpsScaling);
        c.s = dmax(sqrt(c.s), kEpsScaling);
        c.eps = eps_new;
        c.eps_run = dmax(eps_new, pmag * kFpFloor);
        c.budget *= 4.0;
      }
    } else {
      // phase check: the per-row slack, the certificate, the next eps
      for (int i = warp; i < n; i += kWarps) {
        const double* row = benefit + (size_t)i * n;
        double m = -INFINITY;
        for (int j = lane; j < n; j += 32) m = dmax(m, row[j] - prices[j]);
        m = warp_max(m);
        if (lane == 0) {
          const int cc = col[i];
          slack[i] = m - (row[cc] - prices[cc]);
          maxprof[i] = m;
        }
      }
      __syncthreads();
      double smax = -INFINITY;
      long long over = 0;
      for (int k = tid; k < N; k += kThreads) {
        const double v = k < n ? slack[k] : 0.0;
        tree[k] = v;
        if (k < n) {
          smax = dmax(smax, v);
          over += v > eps_final;
        }
      }
      smax = block_max(smax, red_d);
      over = block_sum(over, red_l);
      for (int h = N >> 1; h >= 1; h >>= 1) {
        for (int k = tid; k < h; k += kThreads) tree[k] = tree[k] + tree[k + h];
        __syncthreads();
      }
      if (tid == 0) {
        const double gap = tree[0];
        const bool certified = c.gap_tol > 0.0 && gap <= c.gap_tol;
        double eps_new;
        bool done;
        if (isinf(c.eps)) {  // the first check of a warm start
          done = certified;
          c.rebid = done ? 0 : (int)over;
          eps_new = dmax(dmin(smax, c.spread) / c.s, eps_final);
        } else {
          done = certified || c.eps_run <= eps_final || c.eps_run > c.eps;
          eps_new = dmax(c.eps / c.s, eps_final);
        }
        c.eps = eps_new;
        c.eps_run = dmax(eps_new, pmag * kFpFloor);
        c.done = done;
        c.phases += done ? 0 : 1;
      }
      __syncthreads();
      long long dropped = 0;
      for (int i = tid; i < n; i += kThreads) {
        if (!c.done && slack[i] > c.eps) {
          col[i] = -1;
          ++dropped;
        }
        owner[i] = -1;
        pi[i] = maxprof[i];
      }
      dropped = block_sum(dropped, red_l);
      for (int i = tid; i < n; i += kThreads) {
        if (col[i] >= 0) owner[col[i]] = i;
      }
      if (tid == 0) c.n_un = (int)dropped;
    }
    if (tid == 0) c.outer += 1;
    __syncthreads();
  }

  // ---- outputs ----
  for (int j = tid; j < n; j += kThreads) {
    prices_out[j] = tied ? 0.0 : prices[j];
    col_out[j] = tied ? (have_warm ? warm_col[j] : j) : col[j];
  }
  if (tid == 0) {
    stats[kBad] = n_bad > 0;
    stats[kBlocked] = n_blocked > 0;
    stats[kNForb] = nf;
    stats[kTied] = tied;
    stats[kConverged] = c.done || tied;
    stats[kPhases] = c.phases;
    stats[kRounds] = c.rounds;
    stats[kRebid] = warm_ok ? c.rebid : n;
    stats[kOuter] = c.outer;
  }
}

size_t state_smem_bytes(int n) {
  const size_t bytes = (size_t)n * (2 * sizeof(double) + 2 * sizeof(int));
  return bytes <= kSmemStateMax ? bytes : 0;
}

}  // namespace

extern "C" {

// One solve, launched on `stream`; returns the launch's cudaError_t.
// `benefit` (n * n doubles) may be `cost` itself. `work_f` holds 4 n + N
// doubles (prices, profits, slack, row maxima; the slack sum's tree of N,
// n rounded up to a power of two) and `work_i` 2 n ints (col_of_row,
// owner): `ops.work_sizes`.
int auction_f64(const double* cost, double* benefit, const double* warm_prices,
                const int* warm_col, double warm_scale, int have_warm, double rel_grid,
                double scaling, int forward_reverse, int validate, int gs_threshold,
                int max_iters, int n, double* prices_out, int* col_out, long long* stats,
                double* work_f, int* work_i, cudaStream_t stream) {
  const size_t smem = state_smem_bytes(n);
  if (smem > 0) {  // with the static shared memory it may pass the 48 KB default
    cudaError_t err = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  auction_kernel<<<1, kThreads, smem, stream>>>(
      cost, benefit, warm_prices, warm_col, warm_scale, have_warm, rel_grid, scaling,
      forward_reverse, validate, gs_threshold, max_iters, n, prices_out, col_out, stats,
      work_f, work_i, smem > 0 ? 1 : 0);
  return cudaGetLastError();
}

}  // extern "C"
