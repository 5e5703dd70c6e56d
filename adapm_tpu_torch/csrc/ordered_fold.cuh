// The ordered fold of K3 (ordered_scatter.cu), shared with K15
// (sync_round.cu), which folds value rows read straight from a pool.
//
// Given n entries whose int32 flat targets were stably sorted (sf, with
// perm[j] the batch position of sorted entry j; out-of-range entries
// carry `rows` and sort last), every run of equal in-range targets is
// added into its stored row in run order, so duplicates fold in batch
// order (np.add.at), one IEEE f32 add at a time (__fadd_rn).
//
// A persistent grid of warps, sized to the card. A warp takes one
// contiguous range of about n / warps sorted entries (even shares: a
// round-robin of chunks leaves a ragged last round), walks it in chunks
// of 32, finds the run heads in a chunk with one __ballot_sync, and
// folds every run that starts in its range, following the last one past
// the range's end: a run is read by one warp only, so runs never race
// and no atomics are needed. The warp streams the value rows of its
// runs in sorted order through a per-warp ring of kStages rows in shared
// memory (cp.async, one commit group per row, each lane copying and
// later reading only its own columns), so kStages-1 rows are in flight
// while it adds the current one into the stored row it holds in
// registers. The fold order is the run order. The sorted targets and
// the permutation are read 32 at a time and handed out with shuffles. A
// 512-float row is 4 float4 per lane; other row lengths loop over column
// blocks of 128 elements per warp, and rows whose length is not a
// multiple of 4 (or unaligned pools) take the same kernel with 4-byte
// elements.
//
// Where a value row comes from is the source's business:
//   DenseRows: row perm[j] of a [n, W] buffer (K3);
//   PoolRows:  fill(pool)[sh[perm[j]], sl[perm[j]]] of an [S, R, W] pool,
//              a zero row for an out-of-range coordinate (K15's delta
//              rows, read where they lie instead of extracted first).
#pragma once

#include <cuda_runtime.h>

#include "routed_read.cuh"

namespace adapm {
namespace fold {

constexpr int kStages = 4;   // ring depth, a power of two
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

template <typename T>
struct DenseRows {
  static constexpr bool kMayZero = false;
  const T* vals;
  __device__ __forceinline__ const T* row(long long p, int W) const {
    return vals + p * (long long)W;
  }
};

template <typename T>
struct PoolRows {
  static constexpr bool kMayZero = true;
  const T* pool;
  const int* sh;
  const int* sl;
  int S, R;
  __device__ __forceinline__ const T* row(long long p, int W) const {
    const int s = __ldg(sh + p), r = __ldg(sl + p);
    return (s >= 0 && s < S && r >= 0 && r < R)
               ? pool + ((long long)s * R + r) * W
               : nullptr;
  }
};

// Fold the sorted entries [a, b) (whole runs, all in range) into the
// stored rows, for the columns [cb, cb + 32*kNV) of a row of W elements.
template <typename T, typename Src>
__device__ __forceinline__ void fold_runs(
    T* __restrict__ pool, const int* __restrict__ sf,
    const long long* __restrict__ perm, const Src& vals, long long a,
    long long b, int W, int cb, T* ring, int lane) {
  // windows of 32 sorted entries: the current one and the next
  long long wb = a;
  long long pc = wb + lane < b ? perm[wb + lane] : 0;
  int sc = wb + lane < b ? sf[wb + lane] : -1;
  long long pn = wb + 32 + lane < b ? perm[wb + 32 + lane] : 0;
  int sn = wb + 32 + lane < b ? sf[wb + 32 + lane] : -1;

  auto issue = [&](long long q) {   // value row of entry q into the ring
    const int qo = (int)(q - wb);
    const long long r1 = __shfl_sync(~0u, pc, qo & 31);
    const long long r2 = __shfl_sync(~0u, pn, qo & 31);
    const T* src = vals.row(qo < 32 ? r1 : r2, W);
    T* dst = ring + (int)(q & (kStages - 1)) * (32 * kNV);
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int c = cb + k * 32 + lane;
      if (c >= W) continue;
      if (!Src::kMayZero || src != nullptr)
        cp_async(dst + k * 32 + lane, src + c);
      else   // the slot's last copy was waited for: a plain store is safe
        dst[k * 32 + lane] = zero<T>();
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (a + s < b) issue(a + s);
    cp_async_commit();
  }
  T acc[kNV];
  int cur = -1;
  for (long long p = a; p < b; ++p) {
    const int off = (int)(p - wb);
    if (p + kStages - 1 < b) issue(p + kStages - 1);
    cp_async_commit();
    const int t = __shfl_sync(~0u, sc, off);
    if (t != cur) {                       // a run's head: swap stored rows
      if (cur >= 0) {
        T* dst = pool + (long long)cur * W;
#pragma unroll
        for (int k = 0; k < kNV; ++k) {
          const int c = cb + k * 32 + lane;
          if (c < W) dst[c] = acc[k];
        }
      }
      const T* src = pool + (long long)t * W;
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = cb + k * 32 + lane;
        if (c < W) acc[k] = src[c];
      }
      cur = t;
    }
    cp_async_wait<kStages - 1>();        // entry p's row has landed
    const T* slot = ring + (int)(p & (kStages - 1)) * (32 * kNV);
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int c = cb + k * 32 + lane;
      if (c < W) acc[k] = add_rn(acc[k], slot[k * 32 + lane]);
    }
    if (off == 31) {                      // slide the windows
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

template <typename T, typename Src>
__global__ void __launch_bounds__(kWarps * 32)
    ordered_fold_kernel(T* __restrict__ pool, const int* __restrict__ sf,
                        const long long* __restrict__ perm, Src vals,
                        long long n, int rows, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem) +
            (threadIdx.x >> 5) * (kStages * 32 * kNV);
  const int lane = threadIdx.x & 31;
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
    for (int cb = 0; cb < W; cb += 32 * kNV)
      fold_runs<T, Src>(pool, sf, perm, vals, a, b, W, cb, ring, lane);
  }
}

// The fold of n sorted entries into a pool of `rows` rows of W elements
// of T, on `stream`: returns the launch's cudaError_t.
template <typename T, typename Src>
int launch_fold(T* pool, const int* sf, const long long* perm,
                const Src& vals, long long n, int rows, int W,
                cudaStream_t stream) {
  const int smem = kWarps * kStages * 32 * kNV * (int)sizeof(T);
  static int blocks_per_sm[64];           // per device, 0 = not known yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (blocks_per_sm[dev] == 0) {
    e = cudaFuncSetAttribute(ordered_fold_kernel<T, Src>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, ordered_fold_kernel<T, Src>, kWarps * 32, smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    blocks_per_sm[dev] = (occ > 0 ? occ : 1) * sms;
  }
  const long long chunks = (n + 31) / 32;
  long long blocks = (chunks + kWarps - 1) / kWarps;
  if (blocks > blocks_per_sm[dev]) blocks = blocks_per_sm[dev];
  ordered_fold_kernel<T, Src><<<(unsigned)blocks, kWarps * 32, smem,
                                stream>>>(pool, sf, perm, vals, n, rows, W);
  return (int)cudaGetLastError();
}

}  // namespace fold
}  // namespace adapm
