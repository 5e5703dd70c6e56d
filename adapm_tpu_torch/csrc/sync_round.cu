// K15 sync_round: one planner round over a batch of replicas, the merge
// and the refresh, with no sort.
//
// Replaces the XLA programs adapm_tpu/device/jaxport.py _sync_replicas
// (:126) and _sync_replicas_thresholded (:188): for replica i at
// (r_sh[i], r_cs[i]) of the [S, C, L] cache/delta pair, owned at
// (o_sh[i], o_sl[i]) of the [So, Ro, L] main pool,
//
//   d[i]    = fill(delta)[r_sh[i], r_cs[i]]
//   ship[i] = threshold > 0 ? max|d[i]| >= threshold : true
//             (a held row's two coordinates become OOB: no merge, no
//             refresh, its delta stays)
//   main.at[o_sh, o_sl'].add(d, mode="drop")      in batch order
//   cache.at[r_sh, r_cs'].set(fill(main)[o_sh, o_sl'], mode="drop")
//   delta.at[r_sh, r_cs'].set(0, mode="drop")
//
// bit for bit: an owner row named by shipped replicas e1 < e2 < ... folds
// as ((main + d_e1) + d_e2) + ..., one __fadd_rn at a time, never
// main + (d_e1 + d_e2); of several shipped replicas at one replica row
// the last in batch order sets it (its owner's fresh row, a zero row for
// an out-of-range owner); -0.0 and NaN pass as the adds pass them, and a
// delta row holding a NaN is held (its max-abs is NaN, as jnp.max and
// torch.amax give it, and fails the test).
//
// Bound on an H100: bytes. Each delta row is read once (all of them for
// the threshold's max-abs), each shipped owner row read and written
// once, each shipped replica's cache and delta rows written once; plus
// the four int32 coordinates an entry.
//
// Three launches, made under one lock (no other call's launch on the
// stream falls between them), with no sort: the card orders each owner
// row's fold itself, the fresh row is installed from the registers that
// hold it, and with a threshold the max-abs is taken where the fold
// reads the delta row anyway:
//
//  1. claim: one thread an entry. An entry i with an in-range owner row
//     t takes link[i] = atomicExch(&own[t], i) and atomicAdd(&cnt[t],
//     1): the entries naming t form a list headed at own[t], and
//     cnt[t] + 1 counts them. With an in-range replica row r it takes
//     atomicMax(&rep[r], i), so rep[r] ends as the last entry naming r;
//     finding rep[r] already taken sets the `dup` word (some replica row
//     is named twice). Held entries claim too: entries naming one
//     replica row read one delta row, so they ship or are held
//     together, and the last of them is the last shipped one.
//  2. fold: a warp reads 32 entries' coordinates and claims at once.
//     With a threshold, each delta row the warp folds is first reduced
//     to its max-abs (the add then reads it again, from L1): a held
//     entry adds nothing, installs nothing and keeps its delta. The head
//     of a list of one (every entry of a round whose owners are
//     distinct, as at S=2) loads its delta row and its owner row
//     together, two entries at a time, adds them and stores the owner
//     row; if it won its replica row it also writes the fresh row into
//     `cache` there and, unless `dup` is set, zeros the delta row. The
//     head of a list of k > 1 gathers its k entries by their links: for
//     k <= 32 one per lane, sorted in batch order by a bitonic network of
//     shuffles; above that it scans the batch's owner coordinates in
//     order, 128 entries a step, collecting them into k words of `order`
//     it reserves. It then folds the shipped ones in batch
//     order, loading four rows together before it adds them one by one,
//     and installs the fresh row for every shipped winner among them. A
//     winner whose owner is out of range writes a zero row. Every list
//     head sets own/cnt back to -1, and a winner that cleared its delta
//     (or was held) sets rep back to -1. No atomics touch a row's
//     values: one warp owns each owner row, each replica row has one
//     winner, and no row a warp writes is read by another warp in this
//     launch, except a delta row named twice, which is why `dup` defers
//     the clearing.
//  3. clear: one thread an entry; a winner still holding its rep word
//     (set `dup`) zeros its delta row and sets the word back to -1; the
//     `dup` word goes back to -1.
//
// Scratch (int32): the claims own[So*Ro], cnt[So*Ro], rep[S*C] and dup,
// all -1 between calls (the wrapper makes them before any CUDA graph
// capture); per call cursor, link[n] and order[n], which hold nothing
// between calls. Neither is allocated by a call, so a round can run
// inside a captured graph.
#include <cuda_runtime.h>

#include <climits>
#include <mutex>

#include "routed_read.cuh"

namespace {

using adapm::add_rn;
using adapm::zero;

constexpr int kThreads = 256;
constexpr int kWarps = 8;     // warps per CTA of the fold and the clear
constexpr int kNV = 4;        // elements per lane per column block
constexpr int kBatch = 4;     // a list's rows in flight together
constexpr int kScan = 4;      // chunks of 32 entries a scan loads at once
constexpr int kFree = -1;     // an unclaimed scratch word
constexpr int kHeld = 1 << 30;   // marks a held entry in `order`

__device__ __forceinline__ bool in_range(int s, int r, int S, int R) {
  return s >= 0 && s < S && r >= 0 && r < R;
}

__device__ __forceinline__ float absmax(float m, float x) {
  const float a = fabsf(x);
  return (a > m || a != a) ? a : m;   // NaN sticks: no a > NaN holds
}
__device__ __forceinline__ float absmax(float m, float4 x) {
  return absmax(absmax(absmax(absmax(m, x.x), x.y), x.z), x.w);
}

// One round's pools, coordinates and scratch; W elements of T a row.
template <typename T>
struct Round {
  T* main;
  T* cache;
  T* delta;
  const int* r_sh;
  const int* r_cs;
  const int* o_sh;
  const int* o_sl;
  int* own;      // [So*Ro] the head of each owner row's list
  int* cnt;      // [So*Ro] entries naming it, less one
  int* rep;      // [S*C]   the last entry naming each replica row
  int* dup;      // some replica row is named twice
  int* cursor;   // words of `order` reserved
  int* link;     // [n] the next entry naming the same owner row
  int* order;    // [n] lists of more than 32 entries, in batch order
  int thresholded;   // hold rows whose max-abs is below `threshold`
  float threshold;
  int n, S, C, So, Ro, W;
};

template <typename T>
__device__ __forceinline__ long long owner_row(const Round<T>& q, int i) {
  const int s = __ldg(q.o_sh + i), r = __ldg(q.o_sl + i);
  return in_range(s, r, q.So, q.Ro) ? (long long)s * q.Ro + r : -1;
}

template <typename T>
__device__ __forceinline__ long long replica_row(const Round<T>& q, int i) {
  const int s = __ldg(q.r_sh + i), r = __ldg(q.r_cs + i);
  return in_range(s, r, q.S, q.C) ? (long long)s * q.C + r : -1;
}

template <typename T>
__device__ __forceinline__ void load_block(T (&v)[kNV], const T* row, int cb,
                                           int W, int lane) {
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int c = cb + k * 32 + lane;
    v[k] = row != nullptr && c < W ? row[c] : zero<T>();
  }
}

template <typename T>
__device__ __forceinline__ void store_block(T* row, const T (&v)[kNV],
                                            int cb, int W, int lane) {
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int c = cb + k * 32 + lane;
    if (c < W) row[c] = v[k];
  }
}

__device__ __forceinline__ float warp_absmax(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = absmax(m, __shfl_xor_sync(~0u, m, o));
  return m;
}

// Whether delta rows r1 and r2 (-1: a zero row) ship: always without a
// threshold, else by their max-abs (both rows' loads in flight together).
template <typename T>
__device__ __forceinline__ void ships(const Round<T>& q, long long r1,
                                      long long r2, int lane, bool* s1,
                                      bool* s2) {
  if (!q.thresholded) {
    *s1 = *s2 = true;
    return;
  }
  const T* d1 = r1 >= 0 ? q.delta + r1 * q.W : nullptr;
  const T* d2 = r2 >= 0 ? q.delta + r2 * q.W : nullptr;
  float m1 = 0.f, m2 = 0.f;
  for (int cb = 0; cb < q.W; cb += 32 * kNV) {
    T a[kNV], b[kNV];
    load_block(a, d1, cb, q.W, lane);
    load_block(b, d2, cb, q.W, lane);
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      m1 = absmax(m1, a[k]);
      m2 = absmax(m2, b[k]);
    }
  }
  *s1 = warp_absmax(m1) >= q.threshold;
  *s2 = warp_absmax(m2) >= q.threshold;
}

// 1. the claim: one thread an entry
template <typename T>
__global__ void __launch_bounds__(kThreads) claim_kernel(Round<T> q) {
  const int first = blockIdx.x * kThreads + threadIdx.x;
  if (first == 0) *q.cursor = 0;
  for (int i = first; i < q.n; i += gridDim.x * kThreads) {
    const long long t = owner_row(q, i), r = replica_row(q, i);
    if (t >= 0) {
      q.link[i] = atomicExch(q.own + t, i);
      atomicAdd(q.cnt + t, 1);
    }
    if (r >= 0 && atomicMax(q.rep + r, i) != kFree) *q.dup = 1;
  }
}

// The fresh owner row's block into a winner's cache row, and zeros into
// its delta row when `clear`.
template <typename T>
__device__ __forceinline__ void install_block(const Round<T>& q,
                                              const T (&v)[kNV],
                                              long long r, bool clear,
                                              int cb, int lane) {
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int c = cb + k * 32 + lane;
    if (c >= q.W) continue;
    __stcs(q.cache + r * q.W + c, v[k]);
    if (clear) __stcs(q.delta + r * q.W + c, zero<T>());
  }
}

// Rows that one entry folds alone, two entries at a time (two: false,
// one): owner row t (or -1: none, the fresh row is zeros) plus the delta
// row r (or -1: a zero row), and the winner's install, if the entry
// ships.
template <typename T>
__device__ __forceinline__ void solo_rows(const Round<T>& q, long long t1,
                                          long long r1, bool w1,
                                          long long t2, long long r2,
                                          bool w2, bool two, bool clear,
                                          int lane) {
  bool s1, s2;
  ships(q, r1, two ? r2 : -1, lane, &s1, &s2);
  s2 = s2 && two;
  T* m1 = s1 && t1 >= 0 ? q.main + t1 * q.W : nullptr;
  T* m2 = s2 && t2 >= 0 ? q.main + t2 * q.W : nullptr;
  const T* d1 = m1 != nullptr && r1 >= 0 ? q.delta + r1 * q.W : nullptr;
  const T* d2 = m2 != nullptr && r2 >= 0 ? q.delta + r2 * q.W : nullptr;
  const bool i1 = s1 && w1, i2 = s2 && w2;   // installs
  if (m1 != nullptr || m2 != nullptr || i1 || i2) {
    for (int cb = 0; cb < q.W; cb += 32 * kNV) {
      T a1[kNV], b1[kNV], a2[kNV], b2[kNV];
      load_block(a1, m1, cb, q.W, lane);
      load_block(b1, d1, cb, q.W, lane);
      load_block(a2, m2, cb, q.W, lane);
      load_block(b2, d2, cb, q.W, lane);
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        a1[k] = add_rn(a1[k], b1[k]);
        a2[k] = add_rn(a2[k], b2[k]);
      }
      if (m1 != nullptr) store_block(m1, a1, cb, q.W, lane);
      if (m2 != nullptr) store_block(m2, a2, cb, q.W, lane);
      if (i1) install_block(q, a1, r1, clear, cb, lane);
      if (i2) install_block(q, a2, r2, clear, cb, lane);
    }
  }
  if (lane == 0) {
    if (t1 >= 0) q.own[t1] = q.cnt[t1] = kFree;
    if (two && t2 >= 0) q.own[t2] = q.cnt[t2] = kFree;
    if (w1 && (clear || !s1)) q.rep[r1] = kFree;
    if (two && w2 && (clear || !s2)) q.rep[r2] = kFree;
  }
}

// One value per lane sorted ascending across the warp (bitonic).
__device__ __forceinline__ int warp_sort(int v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(~0u, v, j);
      const bool low = (lane & j) == 0, up = (lane & k) == 0;
      v = low == up ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The ship flags of the first m <= 32 entries of a chunk, lane j's delta
// row r, as a mask; kBatch rows' max-abs at a time.
template <typename T>
__device__ __forceinline__ unsigned ship_mask(const Round<T>& q, long long r,
                                              int m, int lane) {
  if (!q.thresholded) return m >= 32 ? ~0u : (1u << m) - 1;
  unsigned mask = 0;
  for (int j0 = 0; j0 < m; j0 += kBatch) {
    const T* d[kBatch];
    float mx[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long rb = __shfl_sync(~0u, r, (j0 + b) & 31);
      d[b] = j0 + b < m && rb >= 0 ? q.delta + rb * q.W : nullptr;
      mx[b] = 0.f;
    }
    for (int cb = 0; cb < q.W; cb += 32 * kNV) {
      T v[kBatch][kNV];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) load_block(v[b], d[b], cb, q.W, lane);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int k = 0; k < kNV; ++k) mx[b] = absmax(mx[b], v[b][k]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (j0 + b < m && warp_absmax(mx[b]) >= q.threshold)
        mask |= 1u << (j0 + b);
  }
  return mask;
}

// The shipped entries among the first m of a sorted chunk (lane j's delta
// row r; `live`: their mask) added into acc in order, kBatch rows loaded
// together before any of them is added.
template <typename T>
__device__ __forceinline__ void fold_block(const Round<T>& q, T (&acc)[kNV],
                                           long long r, unsigned live, int m,
                                           int cb, int lane) {
  for (int j0 = 0; j0 < m; j0 += kBatch) {
    T v[kBatch][kNV];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long rb = __shfl_sync(~0u, r, (j0 + b) & 31);
      const bool go = j0 + b < m && ((live >> (j0 + b)) & 1);
      load_block(v[b], go && rb >= 0 ? q.delta + rb * q.W : nullptr, cb,
                 q.W, lane);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b >= m || !((live >> (j0 + b)) & 1)) continue;
#pragma unroll
      for (int k = 0; k < kNV; ++k) acc[k] = add_rn(acc[k], v[b][k]);
    }
  }
}

// The owner row t named by the k > 1 entries of the list headed at h:
// its shipped entries folded in batch order, installed for their winners.
template <typename T>
__device__ void many_rows(const Round<T>& q, int h, long long t, int k,
                          bool clear, int lane) {
  T* m = q.main + t * q.W;
  if (k <= 32) {
    int e = INT_MAX, cur = h;
    for (int j = 0; j < k; ++j) {          // the list, one entry a lane
      if (lane == j) e = cur;
      if (j + 1 < k) cur = __ldg(q.link + cur);
    }
    e = warp_sort(e, lane);
    const long long r = lane < k ? replica_row(q, e) : -1;
    const unsigned live = ship_mask(q, r, k, lane);
    const bool win = r >= 0 && q.rep[r] == e;
    const unsigned wins = __ballot_sync(~0u, win) & live;
    for (int cb = 0; cb < q.W; cb += 32 * kNV) {
      T acc[kNV];
      load_block(acc, m, cb, q.W, lane);
      fold_block(q, acc, r, live, k, cb, lane);
      store_block(m, acc, cb, q.W, lane);
      for (unsigned w = wins; w; w &= w - 1)
        install_block(q, acc, __shfl_sync(~0u, r, __ffs(w) - 1), clear, cb,
                      lane);
    }
    if (win && (clear || !((live >> lane) & 1))) q.rep[r] = kFree;
  } else {
    // past 32 entries the warp scans the batch in order for the k
    // entries naming t, into k words of `order` it reserves
    int base = 0;
    if (lane == 0) base = atomicAdd(q.cursor, k);
    volatile int* ord = q.order + __shfl_sync(~0u, base, 0);
    for (int c0 = 0, found = 0; found < k; c0 += 32 * kScan) {
      long long tt[kScan];                 // kScan chunks' loads at once
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int i = c0 + u * 32 + lane;
        tt[u] = i < q.n ? owner_row(q, i) : -1;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const unsigned b = __ballot_sync(~0u, tt[u] == t);
        if (tt[u] == t)
          ord[found + __popc(b & ((1u << lane) - 1))] = c0 + u * 32 + lane;
        found += __popc(b);
      }
    }
    __syncwarp();
    if (q.thresholded) {                   // mark the held entries
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int e = j0 + lane < k ? ord[j0 + lane] : -1;
        const long long r = e >= 0 ? replica_row(q, e) : -1;
        const unsigned live = ship_mask(q, r, min(32, k - j0), lane);
        if (e >= 0 && !((live >> lane) & 1)) ord[j0 + lane] = e | kHeld;
      }
      __syncwarp();
    }
    for (int cb = 0; cb < q.W; cb += 32 * kNV) {
      T acc[kNV];
      load_block(acc, m, cb, q.W, lane);
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int e = j0 + lane < k ? ord[j0 + lane] : (int)kHeld;
        const long long r = e & kHeld ? -1 : replica_row(q, e);
        fold_block(q, acc, r, __ballot_sync(~0u, !(e & kHeld)),
                   min(32, k - j0), cb, lane);
      }
      store_block(m, acc, cb, q.W, lane);
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int e = j0 + lane < k ? ord[j0 + lane] : (int)kHeld;
        const long long r = e & kHeld ? -1 : replica_row(q, e);
        const unsigned wins = __ballot_sync(~0u, r >= 0 && q.rep[r] == e);
        for (unsigned w = wins; w; w &= w - 1)
          install_block(q, acc, __shfl_sync(~0u, r, __ffs(w) - 1), clear,
                        cb, lane);
      }
    }
    __syncwarp();
    // every block is installed: a winner sets its rep word back where it
    // cleared its delta row, or was held
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int e = j0 + lane < k ? ord[j0 + lane] : -1;
      const int ee = e & ~kHeld;
      const long long r = e >= 0 ? replica_row(q, ee) : -1;
      if (r >= 0 && q.rep[r] == ee && (clear || (e & kHeld)))
        q.rep[r] = kFree;
    }
  }
  if (lane == 0) q.own[t] = q.cnt[t] = kFree;
}

// 2. the fold: a warp a chunk of 32 entries
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) fold_kernel(Round<T> q) {
  const int lane = threadIdx.x & 31;
  const bool clear = *q.dup == kFree;     // no replica row named twice
  for (int c0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32; c0 < q.n;
       c0 += gridDim.x * kWarps * 32) {
    const int i = c0 + lane;
    long long t = -1, r = -1;
    int k = 0;
    bool win = false;
    if (i < q.n) {
      t = owner_row(q, i);
      r = replica_row(q, i);
      // own, cnt and rep are set back in this launch: plain loads
      if (t >= 0) {
        const int head = q.own[t], more = q.cnt[t];
        if (head == i) k = more + 1;
      }
      win = r >= 0 && q.rep[r] == i;
    }
    // heads of lists of one, and winners whose owner is out of range
    unsigned solo = __ballot_sync(~0u, k == 1 || (t < 0 && win));
    while (solo) {
      const int j1 = __ffs(solo) - 1;
      solo &= solo - 1;
      const bool two = solo != 0;
      const int j2 = two ? __ffs(solo) - 1 : j1;
      if (two) solo &= solo - 1;
      solo_rows(q, __shfl_sync(~0u, t, j1), __shfl_sync(~0u, r, j1),
                __shfl_sync(~0u, win, j1) != 0, __shfl_sync(~0u, t, j2),
                __shfl_sync(~0u, r, j2), __shfl_sync(~0u, win, j2) != 0,
                two, clear, lane);
    }
    for (unsigned many = __ballot_sync(~0u, k > 1); many; many &= many - 1) {
      const int j = __ffs(many) - 1;
      many_rows(q, c0 + j, __shfl_sync(~0u, t, j), __shfl_sync(~0u, k, j),
                clear, lane);
    }
  }
}

// 3. the clear: winners still holding their rep word (`dup` was set)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) clear_kernel(Round<T> q) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) *q.dup = kFree;
  for (int c0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32; c0 < q.n;
       c0 += gridDim.x * kWarps * 32) {
    const int i = c0 + lane;
    const long long r = i < q.n ? replica_row(q, i) : -1;
    const bool win = r >= 0 && q.rep[r] == i;
    for (unsigned w = __ballot_sync(~0u, win); w; w &= w - 1) {
      const long long rw = __shfl_sync(~0u, r, __ffs(w) - 1);
      for (int c = lane; c < q.W; c += 32)
        __stcs(q.delta + rw * q.W + c, zero<T>());
    }
    if (win) q.rep[r] = kFree;
  }
}

std::mutex& launch_mutex() {   // a call's three launches stay adjacent
  static std::mutex mu;
  return mu;
}

template <typename T>
int launch(const Round<T>& q, cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(launch_mutex());
  long long blocks = ((long long)q.n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  claim_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long chunks = ((long long)q.n + 31) / 32;
  blocks = (chunks + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;
  fold_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  clear_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(q);
  return (int)cudaGetLastError();
}

}  // namespace

// One round. main: [So, Ro, L] f32; cache, delta: [S, C, L] f32; n <=
// 2^30 replicas at int32 (r_sh, r_cs) owned at (o_sh, o_sl) (So * Ro and
// S * C below 2^31 - 1). claims: 2 * So * Ro + S * C + 1 int32 words, all
// -1 before the call and after it; entries: 2 * n + 1 int32 words.
// thresholded: hold rows whose delta max-abs is below `threshold`. vec:
// L % 4 == 0 and main, cache and delta 16-byte aligned.
extern "C" int adapm_sync_round(float* main, float* cache, float* delta,
                                const int* r_sh, const int* r_cs,
                                const int* o_sh, const int* o_sl, int n,
                                int S, int C, int So, int Ro, int L,
                                int* claims, int* entries, int thresholded,
                                float threshold, int vec,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  if (claims == nullptr || entries == nullptr || n > kHeld)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)So * Ro;
  int* own = claims;
  int* cnt = claims + rows;
  int* rep = claims + 2 * rows;
  int* dup = rep + (long long)S * C;
  int* link = entries + 1;
  int* order = link + n;
  if (vec)
    return launch(Round<float4>{reinterpret_cast<float4*>(main),
                                reinterpret_cast<float4*>(cache),
                                reinterpret_cast<float4*>(delta), r_sh, r_cs,
                                o_sh, o_sl, own, cnt, rep, dup, entries,
                                link, order, thresholded, threshold, n, S,
                                C, So, Ro, L / 4},
                  stream);
  return launch(Round<float>{main, cache, delta, r_sh, r_cs, o_sh, o_sl, own,
                             cnt, rep, dup, entries, link, order,
                             thresholded, threshold, n, S, C, So, Ro, L},
                stream);
}
