// K8 gather_pool: the fused embedding-bag read of the serving plane.
//
// Replaces the XLA program adapm_tpu/device/jaxport.py _gather_pool
// (with its _pool_rows): each member entry i reads its row exactly as
// K1's cache+delta form does (routed_read.cuh: main, or cache+delta,
// zero for an out-of-range coordinate), and the rows fold into their
// bags,
//
//   out[seg[i]] += row[i]            in batch order (np.add.at),
//
// dropping any member whose seg is out of range (bucket padding carries
// seg = OOB). For mean pooling each bag is then divided once by its
// member count (an f32 IEEE division, __fdiv_rn); an empty bag gives
// exact zeros. Every add is __fadd_rn, so nvcc cannot reassociate or
// contract; the result is bit for bit NumpyRefPort.gather_pool's.
//
// Bound on an H100: bytes. The work is the member rows' bytes (the
// distinct rows of the batch, once each), the coordinates and the
// pooled rows written; there is one add per member value. What the
// fused read saves over gather + pool is the [n, L] rows tensor: this
// kernel writes none. Design: one warp per bag. seg is non-decreasing
// on the serving path (serve/bags.py plan_bag_batch builds it so and
// padding appends OOB), so bag b's members are one contiguous run; the
// warp finds it with two 33-ary searches (32 probes a round, about 5
// dependent rounds at 4e5 members), then folds the run in order into
// registers, kGroup members at a time: the group's coordinates are
// resolved by its first lanes, every load of the group is issued
// before the first add, then the adds run in member order. The pooled
// row is written once. Rows of a multiple of 4 floats (the serving
// path's L = 256: two float4 a lane) take 16-byte loads; other lengths
// take the same kernel with 4-byte elements. Where seg is not sorted
// (a direct call), the wrapper orders the members first with K3's
// stable ordering and passes the permutation; the fold then reads
// member perm[j] at sorted position j, which keeps batch order within
// each bag.
#include <cuda_runtime.h>

#include "routed_read.cuh"

namespace {

using adapm::add_rn;
using adapm::routed_load;
using adapm::routed_source;
using adapm::routed_value;
using adapm::zero;

constexpr int kWarps = 8;    // warps (bags) per block
constexpr int kGroup = 4;    // members whose loads are in flight together
constexpr int kNV = 2;       // elements per lane per column block

__device__ __forceinline__ float div_rn(float a, float d) {
  return __fdiv_rn(a, d);
}

__device__ __forceinline__ float4 div_rn(float4 a, float d) {
  return make_float4(__fdiv_rn(a.x, d), __fdiv_rn(a.y, d),
                     __fdiv_rn(a.z, d), __fdiv_rn(a.w, d));
}

// First position in the non-decreasing seg[0, n) whose value is >= v,
// searched by the whole warp: each round the 32 lanes probe 32 evenly
// spaced positions of the open range and keep the gap between the last
// probe below v and the first at or above it.
__device__ __forceinline__ long long warp_lower_bound(const int* seg,
                                                      long long n,
                                                      long long v,
                                                      int lane) {
  long long lo = 0, hi = n;          // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long p = lo + (hi - lo) * (lane + 1) / 33;   // in [lo, hi)
    const bool below = (long long)__ldg(seg + p) < v;
    const int k = __popc(__ballot_sync(~0u, below));        // a prefix
    const long long last = __shfl_sync(~0u, p, k > 0 ? k - 1 : 0);
    const long long next = __shfl_sync(~0u, p, k < 32 ? k : 31);
    if (k > 0) lo = last + 1;
    if (k < 32) hi = next;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) gather_pool_kernel(
    const T* __restrict__ main_pool, const T* __restrict__ cache,
    const T* __restrict__ delta, const int* __restrict__ o_sh,
    const int* __restrict__ o_sl, const int* __restrict__ c_sh,
    const int* __restrict__ c_sl, const unsigned char* __restrict__ use_c,
    const int* __restrict__ seg, const long long* __restrict__ perm,
    long long n, T* __restrict__ out, int nbags, int shards, int slots,
    int c_shards, int c_slots, int W, int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                      >> 5;
  if (b >= nbags) return;            // the whole warp leaves together
  const long long lo = warp_lower_bound(seg, n, b, lane);
  const long long hi = warp_lower_bound(seg, n, b + 1, lane);
  // an empty bag keeps its starting value under sum, so its row is
  // neither read nor written (the bucket's padding bags, past the last)
  if (hi == lo && !mean) return;
  T* o = out + b * (long long)W;
  for (int cb = 0; cb < W; cb += 32 * kNV) {
    T acc[kNV];
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int c = cb + k * 32 + lane;
      acc[k] = c < W ? o[c] : zero<T>();
    }
    for (long long j0 = lo; j0 < hi; j0 += kGroup) {
      // lane g < kGroup resolves member j0 + g of the run
      long long src = -2;                       // -2: past the run
      bool from_c = false;
      if (lane < kGroup && j0 + lane < hi) {
        const long long m = perm != nullptr ? perm[j0 + lane] : j0 + lane;
        src = routed_source<true>(o_sh, o_sl, c_sh, c_sl, use_c, m, shards,
                                  slots, c_shards, c_slots, W, &from_c);
      }
      long long gsrc[kGroup];
      bool gc[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        gsrc[g] = __shfl_sync(~0u, src, g);
        gc[g] = __shfl_sync(~0u, (int)from_c, g) != 0;
      }
      T va[kGroup][kNV], vb[kGroup][kNV];
      // every load of the group first ...
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
#pragma unroll
        for (int k = 0; k < kNV; ++k) {
          const int c = cb + k * 32 + lane;
          // a column past the row loads nothing (its src reads as a
          // zero row) and is never stored
          routed_load<T, true>(main_pool, cache, delta,
                               c < W ? gsrc[g] : -1, gc[g], c, &va[g][k],
                               &vb[g][k]);
        }
      }
      // ... then the adds, in member order
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (gsrc[g] == -2) break;
#pragma unroll
        for (int k = 0; k < kNV; ++k)
          acc[k] = add_rn(acc[k], routed_value<T, true>(
                                      va[g][k], vb[g][k], gsrc[g], gc[g]));
      }
    }
    if (mean) {
      const float cnt = (float)(hi - lo);      // exact below 2^24
#pragma unroll
      for (int k = 0; k < kNV; ++k)
        acc[k] = hi > lo ? div_rn(acc[k], cnt) : zero<T>();
    }
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int c = cb + k * 32 + lane;
      if (c < W) __stcs(o + c, acc[k]);
    }
  }
}

template <typename T>
int launch(const T* main_pool, const T* cache, const T* delta,
           const int* o_sh, const int* o_sl, const int* c_sh,
           const int* c_sl, const unsigned char* use_c, const int* seg,
           const long long* perm, long long n, T* out, int nbags,
           int shards, int slots, int c_shards, int c_slots, int W,
           int mean, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((nbags + kWarps - 1) / kWarps);
  gather_pool_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      main_pool, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c, seg, perm, n,
      out, nbags, shards, slots, c_shards, c_slots, W, mean);
  return (int)cudaGetLastError();
}

}  // namespace

// n members with coordinates o_sh, o_sl, c_sh, c_sl, use_c and
// non-decreasing bag indices seg; perm (nullable, int64) names the
// member at each sorted position. out is [nbags, L],
// read as each bag's starting value and overwritten with the pooled
// row. vec: L % 4 == 0 and every pool and out 16-byte aligned.
extern "C" int adapm_gather_pool(
    const float* main_pool, const float* cache, const float* delta,
    const int* o_sh, const int* o_sl, const int* c_sh, const int* c_sl,
    const unsigned char* use_c, const int* seg, const long long* perm,
    long long n, float* out, int nbags, int shards, int slots, int c_shards,
    int c_slots, int L, int mean, int vec, cudaStream_t stream) {
  if (cache == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  if (nbags <= 0) return 0;
  if (vec)
    return launch<float4>(reinterpret_cast<const float4*>(main_pool),
                          reinterpret_cast<const float4*>(cache),
                          reinterpret_cast<const float4*>(delta), o_sh, o_sl,
                          c_sh, c_sl, use_c, seg, perm, n,
                          reinterpret_cast<float4*>(out), nbags, shards,
                          slots, c_shards, c_slots, L / 4, mean, stream);
  return launch<float>(main_pool, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c,
                       seg, perm, n, out, nbags, shards, slots, c_shards,
                       c_slots, L, mean, stream);
}
