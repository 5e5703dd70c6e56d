// The ordered fold of K3 (ordered_scatter.cu).
//
// Given n entries whose int32 flat targets were stably sorted (sf, with
// perm[j] the batch position of sorted entry j; out-of-range entries
// carry `rows` and sort last), every run of equal in-range targets is
// added into its stored row in run order, so duplicates fold in batch
// order (np.add.at), one IEEE f32 add at a time (__fadd_rn).
//
// Bound on an H100: bytes (each value row read once, each distinct
// stored row read and written once, the sorted targets and the
// permutation). What holds a fold back is the bytes it keeps in flight:
// HBM3 streams only with several MiB outstanding across the card.
//
// The grid has two dimensions. Along x, a persistent set of warps sized
// to the card: a warp takes one contiguous range of about n / warps
// sorted entries (even shares: a round-robin of chunks leaves a ragged
// last round), walks it in chunks of 32, finds the run heads in a chunk
// with one __ballot_sync, and folds every run that starts in its range,
// following the last one past the range's end. Along y, column slabs: a
// row of W elements is cut into column blocks of 32 * kNV elements (one
// float4 or float per lane and step), and slab y owns a contiguous range
// of them. So one warp owns one (range of runs, slab) pair; each element
// of a stored row is folded by exactly one warp, in run order, and runs
// never race: no atomics, and the result is the same from run to run.
// The slab count comes from the card's resident CTAs over the CTAs the
// entries need, at most the number of column blocks: rows of 512 f32
// (one column block of 128 float4) take one slab, as many warps as
// entries allow; K16's relation rows of 32,768 f32 (64 column blocks)
// at 4,096 entries take about a dozen, so some 1,400 warps stream (the
// entries alone would give 128).
//
// Within its slab a warp streams, for each column block, one item
// sequence through a per-warp ring of kStages slots in shared memory
// (cp.async, one commit group per item, each lane copying and later
// reading only its own columns): every run's stored row, then the run's
// value rows in run order. kStages - 1 items are in flight while the warp
// adds the current one into the stored row it holds in registers, and a
// run's stored row arrives through the ring like a value row, so a run
// head costs no exposed memory latency. The sorted targets and the
// permutation are read 32 at a time and handed out with shuffles. Rows
// whose length is not a multiple of 4 (or unaligned pools) take the same
// kernel with 4-byte elements.
//
// Shared memory a CTA: kWarps * kStages * 32 * kNV * sizeof(T), i.e. 32
// KiB at kStages = 4 (one column block: the ring covers the few entries
// a warp folds between run heads) and 64 KiB at kStages = 8 (several
// column blocks, wide rows: 7 items of 2 KiB in flight a warp).
#pragma once

#include <cuda_runtime.h>

#include "routed_read.cuh"

namespace adapm {
namespace fold {

constexpr int kWarps = 4;    // warps per block of the fold
constexpr int kNV = 4;       // elements per lane per column block

__device__ __forceinline__ void cp_async(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fold the sorted entries [a, b) (whole runs, all in range) into the
// stored rows, for the columns [cb, cb + 32*kNV) of a row of W elements.
// The item sequence is, run by run, the stored row and then the run's
// value rows; items are issued kStages - 1 ahead of the one consumed.
template <typename T, int kStages>
__device__ __forceinline__ void fold_runs(
    T* __restrict__ pool, const int* __restrict__ sf,
    const long long* __restrict__ perm, const T* __restrict__ vals,
    long long a, long long b, int W, int cb, T* ring, int lane) {
  // windows of 32 sorted entries: the current one (from wb) and the
  // next; the issue cursor runs at most kStages - 1 entries ahead of the
  // consumed one, so it stays inside them
  long long wb = a;
  long long pc = wb + lane < b ? perm[wb + lane] : 0;
  int sc = wb + lane < b ? sf[wb + lane] : -1;
  long long pn = wb + 32 + lane < b ? perm[wb + 32 + lane] : 0;
  int sn = wb + 32 + lane < b ? sf[wb + 32 + lane] : -1;
  int s_prev = -1;                        // sf[wb - 1], once wb > a

  auto target = [&](long long q) {        // sf[q], q in [wb - 1, wb + 64)
    const int qo = (int)(q - wb);
    const int t1 = __shfl_sync(~0u, sc, qo & 31);
    const int t2 = __shfl_sync(~0u, sn, qo & 31);
    return qo < 0 ? s_prev : qo < 32 ? t1 : t2;
  };
  auto head = [&](long long q) {          // entry q starts a run
    const int t = target(q);
    const int before = target(q - 1);
    return q == a || t != before;
  };

  long long iq = a;       // next entry to issue
  bool i_row = false;     // its stored row is issued (or it is no head)
  unsigned issued = 0;
  auto issue = [&]() {    // the next item into its slot, one commit group
    if (iq < b) {
      const int qo = (int)(iq - wb);
      const long long r1 = __shfl_sync(~0u, pc, qo & 31);
      const long long r2 = __shfl_sync(~0u, pn, qo & 31);
      const bool h = head(iq);
      const T* src;
      if (h && !i_row) {
        src = pool + (long long)target(iq) * W;
        i_row = true;
      } else {
        src = vals + (qo < 32 ? r1 : r2) * (long long)W;
        ++iq;
        i_row = false;
      }
      T* dst = ring + (int)(issued & (kStages - 1)) * (32 * kNV);
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = cb + k * 32 + lane;
        if (c < W) cp_async(dst + k * 32 + lane, src + c);
      }
    }
    ++issued;
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();
  T acc[kNV];
  int cur = -1;
  bool c_row = false;     // the consumed entry's stored row is taken
  unsigned consumed = 0;
  for (long long p = a; p < b;) {
    issue();
    cp_async_wait<kStages - 1>();         // the oldest item has landed
    const T* slot = ring + (int)(consumed & (kStages - 1)) * (32 * kNV);
    ++consumed;
    if (head(p) && !c_row) {              // a run's stored row
      if (cur >= 0) {
        T* dst = pool + (long long)cur * W;
#pragma unroll
        for (int k = 0; k < kNV; ++k) {
          const int c = cb + k * 32 + lane;
          if (c < W) dst[c] = acc[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = cb + k * 32 + lane;
        if (c < W) acc[k] = slot[k * 32 + lane];
      }
      cur = target(p);
      c_row = true;
      continue;
    }
#pragma unroll
    for (int k = 0; k < kNV; ++k) {       // entry p's value row
      const int c = cb + k * 32 + lane;
      if (c < W) acc[k] = add_rn(acc[k], slot[k * 32 + lane]);
    }
    c_row = false;
    if ((int)(++p - wb) == 32) {          // slide the windows
      s_prev = __shfl_sync(~0u, sc, 31);
      wb += 32;
      pc = pn;
      sc = sn;
      pn = wb + 32 + lane < b ? perm[wb + 32 + lane] : 0;
      sn = wb + 32 + lane < b ? sf[wb + 32 + lane] : -1;
    }
  }
  if (cur >= 0) {
    T* dst = pool + (long long)cur * W;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int c = cb + k * 32 + lane;
      if (c < W) dst[c] = acc[k];
    }
  }
  cp_async_wait<0>();
}

// blockIdx.y is the column slab: column blocks [y * per_slab,
// (y + 1) * per_slab) of the ceil(W / (32 * kNV)) a row has.
template <typename T, int kStages>
__global__ void __launch_bounds__(kWarps * 32)
    ordered_fold_kernel(T* __restrict__ pool, const int* __restrict__ sf,
                        const long long* __restrict__ perm,
                        const T* __restrict__ vals, long long n, int rows,
                        int W, int per_slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem) +
            (threadIdx.x >> 5) * (kStages * 32 * kNV);
  const int lane = threadIdx.x & 31;
  const int cb_lo = (int)blockIdx.y * per_slab * (32 * kNV);
  const int cb_hi = min(W, cb_lo + per_slab * (32 * kNV));
  // each warp folds the runs headed in one contiguous range of about
  // n / warps sorted entries, walked in chunks of 32
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long per = (n + nwarps - 1) / nwarps;
  const long long lo =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per;
  const long long hi = lo + per < n ? lo + per : n;
  for (long long c0 = lo; c0 < hi; c0 += 32) {
    const long long i = c0 + lane;
    const int t = i < n ? sf[i] : rows;
    int prev = __shfl_up_sync(~0u, t, 1);
    if (lane == 0) prev = c0 > 0 ? sf[c0 - 1] : -1;
    const unsigned heads =
        __ballot_sync(~0u, i < hi && t < rows && prev != t);
    if (heads == 0) continue;             // inside a run headed earlier
    const long long a = c0 + (__ffs(heads) - 1);
    const int last = 31 - __clz(heads);
    const int t_last = __shfl_sync(~0u, t, last);
    // the end of the last run headed here, possibly past the chunk
    const unsigned after = __ballot_sync(~0u, lane > last && t != t_last);
    long long b = after ? c0 + (__ffs(after) - 1) : -1;
    for (long long j0 = c0 + 32; b < 0; j0 += 32) {
      const long long j = j0 + lane;
      const unsigned m = __ballot_sync(~0u, j >= n || sf[j] != t_last);
      if (m) b = j0 + (__ffs(m) - 1);
    }
    for (int cb = cb_lo; cb < cb_hi; cb += 32 * kNV)
      fold_runs<T, kStages>(pool, sf, perm, vals, a, b, W, cb, ring, lane);
  }
}

// The grid of one fold: x CTAs along the entries, y column slabs of
// per_slab column blocks each, the ring's depth, the shared memory a CTA.
struct FoldGrid {
  int x, y, per_slab, stages, smem;
};

// The grid of a fold of n entries over rows of W elements of T on the
// current device: returns a cudaError_t.
template <typename T, int kStages>
int fold_grid(long long n, int W, FoldGrid* grid) {
  const int smem = kWarps * kStages * 32 * kNV * (int)sizeof(T);
  static int resident[64];                // CTAs a device holds, 0: unknown
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    e = cudaFuncSetAttribute(ordered_fold_kernel<T, kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, ordered_fold_kernel<T, kStages>, kWarps * 32, smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = (occ > 0 ? occ : 1) * sms;
  }
  const long long chunks = (n + 31) / 32;
  long long bx = (chunks + kWarps - 1) / kWarps;
  if (bx > resident[dev]) bx = resident[dev];
  if (bx < 1) bx = 1;
  // slabs fill the CTAs the entries leave free, each slab whole blocks
  const int ncb = (W + 32 * kNV - 1) / (32 * kNV);
  long long slabs = resident[dev] / bx;
  if (slabs < 1) slabs = 1;
  if (slabs > ncb) slabs = ncb;
  const int per_slab = (int)((ncb + slabs - 1) / slabs);
  *grid = FoldGrid{(int)bx, (ncb + per_slab - 1) / per_slab, per_slab,
                   kStages, smem};
  return 0;
}

// The fold of n sorted entries into a pool of `rows` rows of W elements
// of T, on `stream`: returns the launch's cudaError_t.
template <typename T, int kStages>
int launch_fold(T* pool, const int* sf, const long long* perm,
                const T* vals, long long n, int rows, int W,
                cudaStream_t stream) {
  FoldGrid g;
  const int e = fold_grid<T, kStages>(n, W, &g);
  if (e != 0) return e;
  ordered_fold_kernel<T, kStages>
      <<<dim3((unsigned)g.x, (unsigned)g.y), kWarps * 32, g.smem,
         stream>>>(pool, sf, perm, vals, n, rows, W, g.per_slab);
  return (int)cudaGetLastError();
}

}  // namespace fold
}  // namespace adapm
