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
// kernel writes none.
//
// Design. seg is non-decreasing (serve/bags.py plan_bag_batch builds it
// so and padding appends OOB; where it is not, the wrapper orders the
// members first with K3's stable ordering and passes the permutation,
// and the fold reads member perm[j] at sorted position j). So each bag
// is one run of positions, and each column of a bag folds on its own:
// a bag's columns can go to different warps without changing a bit,
// while its members must fold one after another. On the serving path
// most bags hold 1-3 members and one in 26 holds 100, so in a fold of
// one warp a bag the longest bag's chain, not the bytes, set the pace.
// Here:
//
// - A work item is one span of kSpan seg positions and one slice of 32
//   columns (of T: float4 where L % 4 == 0). It owns the bags whose
//   first member lies in its span and folds them, for its columns, as
//   one stream of members in order. Bag bounds come from one coalesced
//   look at seg[j-1], seg[j] over the span (a bag starts where seg
//   changes); no search.
// - Sources are resolved off the chain: the coordinates of the stream's
//   next batch of 32 members are loaded two batches ahead into
//   registers, one member a lane, and turned by routed_source into a
//   row offset and a cache flag in shared memory a batch ahead.
// - The fold issues only row loads: each lane keeps kDepth members'
//   loads of its column (main, or cache and delta, and the bag's
//   starting value at a bag's first member) in flight in a cp.async
//   ring in shared memory, and adds them in member order as they land.
//   Four are enough: a deeper ring costs shared memory that more
//   resident warps use better (scripts/k8_variants.py).
// - A persistent grid of as many CTAs as fit on the card at once takes
//   the first wave of items by stride, so at the serving path's batch
//   (fewer items than warps) every bag starts at once and no warp waits
//   on a counter. Where the items outnumber the warps, a warp that is
//   done takes its next item from a counter, so the warps that drew
//   long streams take fewer items. The counter is the launch stream's
//   own: launches on one stream run one after another, and the last
//   warp of a launch resets it. Long spans first, or all items from the
//   counter, cost more than they gave (tools/k8_variants.py).
// - Under mean, a run of empty bags becomes zeros: written by the warp
//   whose span holds the run's end, but for the chunks of kChunk bags
//   that lie wholly inside it, which are items of their own (the
//   bucket's padding bags would otherwise fall to one warp).
//
// K10 gather_pool_cold, the same kernel with the cold source of a tiered
// store as a template parameter (kCold: quant.cuh's wire mode, 0 for
// K8), replaces jaxport.py _gather_pool_cold, _gather_pool_cold_fp16 and
// _gather_pool_cold_int8 (jaxport.py:269, :341, :354): a member with
// use_cold (and not use_c) reads its row from the staged [n, L] wire
// buffer of the batch instead of the hot pool, dequantized as quant.cuh
// does (tier/quant.py's dequantize_rows, bit for bit). The
// source-resolution step points such a member at its staging row (a
// code at or past kColdBase) and, for int8, keeps its scale beside the
// code; the ring carries the wire bytes (16, 8 or 4 a lane per four
// columns), and the fold decodes them. The batch-order fold and the
// mean's division are K8's. With kCold = 0 every cold branch is
// discarded at compile time: K8's instantiation is K8's own code.
//
// K10's fold is its own (if constexpr on kCold). At the bag path's
// batch of 8 requests neither bytes nor the ring's depth set its pace
// (tools/k10_variants.py: int8 or fp32 wire rows and all-hot members
// run alike, a deeper ring does not help, dropping the row copies saves
// a third); the fold's per-member shared-memory traffic does. So a
// resolved member is one 16-byte record (ColdMeta: code, bag with its
// first-member flag, scale), read once at the member's issue and held
// in registers until its fold, with the member's ring stage fixed at
// compile time; per member the fold reads one record and one ring
// value.
#include <cuda_runtime.h>

#include <mutex>
#include <type_traits>

#include "quant.cuh"
#include "routed_read.cuh"

namespace {

using adapm::add_rn;
using adapm::routed_source;
using adapm::zero;

constexpr int kWarps = 4;    // warps per CTA
constexpr int kSpan = 64;    // seg positions per work item
constexpr int kDepth = 4;    // members in flight per lane (the ring)
constexpr int kChunk = 64;   // bags per zeroing item (mean pooling)
constexpr int kSlots = 64;   // streams with a work counter of their own
constexpr long long kColdBase = 1LL << 62;   // codes of cold members

// per stream slot: the next item past the first wave, and the warps done
__device__ unsigned long long g_next[kSlots];
__device__ unsigned int g_done[kSlots];

__device__ __forceinline__ float div_rn(float a, float d) {
  return __fdiv_rn(a, d);
}

__device__ __forceinline__ float4 div_rn(float4 a, float d) {
  return make_float4(__fdiv_rn(a.x, d), __fdiv_rn(a.y, d),
                     __fdiv_rn(a.z, d), __fdiv_rn(a.w, d));
}

__device__ __forceinline__ void cp_async(void* dst, const float4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async(void* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// raw wire bytes of a cold member (8: four halves, 4: four int8)
__device__ __forceinline__ void cp_async_bytes8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_bytes4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp's shared memory: the ring (per stage and lane: the member's
// main or cache value, its delta value, the bag's starting value) and
// two batches of resolved members.
template <typename T, int kCold>
struct WarpSmem {
  T ring[kDepth][3][32];
  long long code[2][32];   // row offset >= 0: main; -1: a zero row;
                           // <= -2: cache+delta at offset -2 - code
  int bag[2][32];          // the member's bag, -1 past the stream
  unsigned char first[2][32];   // the member starts its bag
};

// K10: a resolved member as one 16-byte record: K8's code (or a cold
// member's code, kColdBase + its staging row), its bag (-1 past the
// stream; + kFirst where the member starts its bag), its int8 scale
constexpr int kFirst = 1 << 30;
struct alignas(16) ColdMeta {
  long long code;
  int bag;
  float scale;
};
template <typename T>
struct ColdWarpSmem {
  T ring[kDepth][3][32];
  ColdMeta meta[2][32];
};
template <typename T, int kCold>
using SmemOf =
    std::conditional_t<kCold != 0, ColdWarpSmem<T>, WarpSmem<T, kCold>>;

struct Args {
  const int *o_sh, *o_sl, *c_sh, *c_sl;
  const unsigned char* use_c;
  const int* seg;
  const long long* perm;
  long long n;
  int nbags, shards, slots, c_shards, c_slots, W, mean, slices;
  long long span_items, items;   // the span items, then (mean) chunks
  int slot;   // the stream's counter, or -1: every item by stride
  // K10: the staged wire rows, their int8 scales and the cold members
  const void* cold;
  const float* cold_scale;
  const unsigned char* use_cold;
  int L;
};

// A member's coordinates as loaded (two batches ahead of its fold); K10
// adds the cold flag and the member's index (its staging row).
struct Raw {
  int seg, o_sh, o_sl, c_sh, c_sl;
  unsigned char use_c;
};
struct ColdRaw : Raw {
  unsigned char use_cold;
  long long m;
};
template <int kCold>
using RawOf = std::conditional_t<kCold != 0, ColdRaw, Raw>;

__device__ __forceinline__ int clamp_bag(int s, int nbags) {
  return s < 0 ? -1 : (s >= nbags ? nbags : s);
}

template <int kCold>
__device__ __forceinline__ RawOf<kCold> load_raw(const Args& a, long long j) {
  RawOf<kCold> r{};
  r.seg = a.nbags;
  if (j < a.n) {
    const long long m = a.perm != nullptr ? __ldg(a.perm + j) : j;
    r.seg = __ldg(a.seg + j);
    r.use_c = __ldg(a.use_c + m);
    r.o_sh = __ldg(a.o_sh + m);
    r.o_sl = __ldg(a.o_sl + m);
    r.c_sh = __ldg(a.c_sh + m);
    r.c_sl = __ldg(a.c_sl + m);
    if constexpr (kCold != 0) {
      r.use_cold = __ldg(a.use_cold + m);
      r.m = m;
    }
  }
  return r;
}

// K10: start the copy of cold member m's wire bytes for column c into
// its ring slot. Halves and int8 of a 4-byte element path are read and
// widened here (cp.async copies 4 bytes at least); they are exact.
template <typename T, int kCold>
__device__ __forceinline__ void cold_issue(T* dst, const Args& a,
                                           long long m, int c) {
  if constexpr (kCold == adapm::kWireF32) {
    cp_async(dst, reinterpret_cast<const T*>(a.cold) + m * a.W + c);
  } else if constexpr (sizeof(T) == 16) {
    if constexpr (kCold == adapm::kWireF16)
      cp_async_bytes8(dst, reinterpret_cast<const __half*>(a.cold) +
                               m * a.L + 4 * c);
    else
      cp_async_bytes4(dst, reinterpret_cast<const signed char*>(a.cold) +
                               m * a.L + 4 * c);
  } else if constexpr (kCold == adapm::kWireF16) {
    *reinterpret_cast<float*>(dst) = __half2float(
        reinterpret_cast<const __half*>(a.cold)[m * a.L + c]);
  } else {
    *reinterpret_cast<float*>(dst) =
        (float)reinterpret_cast<const signed char*>(a.cold)[m * a.L + c];
  }
}

// K10: a cold member's value from its ring slot
template <typename T, int kCold>
__device__ __forceinline__ T cold_value(const T& slot, float s) {
  if constexpr (kCold == adapm::kWireF32) {
    return slot;
  } else if constexpr (sizeof(T) == 16) {
    if constexpr (kCold == adapm::kWireF16)
      return adapm::decode_f16x4(*reinterpret_cast<const uint2*>(&slot));
    else
      return adapm::decode_i8x4(*reinterpret_cast<const unsigned*>(&slot),
                                s);
  } else if constexpr (kCold == adapm::kWireF16) {
    return slot;
  } else {
    return __fmul_rn(*reinterpret_cast<const float*>(&slot), s);
  }
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

// the warp's next item past the first wave, from the stream's counter
__device__ __forceinline__ long long take(int slot, int lane) {
  unsigned long long v = 0;
  if (lane == 0) v = atomicAdd(&g_next[slot], 1ull);
  return (long long)__shfl_sync(~0u, v, 0);
}

template <typename T, int kCold>
__global__ void __launch_bounds__(kWarps * 32) gather_pool_kernel(
    const T* __restrict__ main_pool, const T* __restrict__ cache,
    const T* __restrict__ delta, T* __restrict__ out, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  SmemOf<T, kCold>& sm = reinterpret_cast<SmemOf<T, kCold>*>(smem_raw)[wid];
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long item = (long long)blockIdx.x * kWarps + wid;
       item < a.items;
       item = a.slot >= 0 ? nwarps + take(a.slot, lane) : item + nwarps) {
    if (item >= a.span_items) {
      // mean: kChunk bags that no member falls in become zeros here, so
      // that a long run of empty bags (the bucket's padding) is spread
      // over many warps
      const long long z = item - a.span_items;
      const int c = (int)(z % a.slices) * 32 + lane;
      const int b0 = (int)(z / a.slices) * kChunk;
      const int b1 = min(b0 + kChunk, a.nbags);
      const long long p = warp_lower_bound(a.seg, a.n, b0, lane);
      if ((p == a.n || __ldg(a.seg + p) >= b1) && c < a.W)
        for (int b = b0; b < b1; ++b)
          __stcs(out + (long long)b * a.W + c, zero<T>());
      continue;
    }
    const long long span = item / a.slices;
    const int c = (int)(item % a.slices) * 32 + lane;   // this lane's column
    const bool col = c < a.W;
    const long long s0 = span * kSpan, s1 = s0 + kSpan;
    // the bags that start in the span (a change of seg at position j in
    // [s0, s1), j <= n; position n ends the last run), and under mean
    // the empty bags between two runs, written as zeros here but for
    // the chunks that lie wholly among them (a chunk item's)
    long long start = -1;
    for (int h = 0; h < kSpan; h += 32) {
      const long long j = s0 + h + lane;
      const bool in = j <= a.n;
      int p = -1, q = a.nbags;
      if (in) {
        if (j > 0) p = clamp_bag(__ldg(a.seg + j - 1), a.nbags);
        if (j < a.n) q = clamp_bag(__ldg(a.seg + j), a.nbags);
      }
      const unsigned starts =
          __ballot_sync(~0u, in && q != p && q >= 0 && q < a.nbags);
      if (start < 0 && starts) start = s0 + h + __ffs(starts) - 1;
      if (a.mean) {
        unsigned gaps = __ballot_sync(~0u, in && q > p + 1);
        while (gaps) {
          const int l = __ffs(gaps) - 1;
          gaps &= gaps - 1;
          const int lo = __shfl_sync(~0u, p, l) + 1;
          const int hi = __shfl_sync(~0u, q, l);
          for (int b = lo; b < hi; ++b) {
            const int b0 = b / kChunk * kChunk;
            const int b1 = min(b0 + kChunk, a.nbags);
            if (b0 >= lo && b1 <= hi)        // a chunk item's
              b = b1 - 1;
            else if (col)
              __stcs(out + (long long)b * a.W + c, zero<T>());
          }
        }
      }
    }
    if (start < 0) continue;             // whole warp: no bag starts here
    // the stream: from `start` to the first change of seg at or past
    // s1, or to the first member outside [0, nbags)
    int carry = -1;                      // clamped seg of the last member
    bool ended = false;
    // resolve the batch of members [base, base + 32) from `r` into buf
    auto resolve = [&](long long base, const RawOf<kCold>& r, int buf) {
      const long long j = base + lane;
      const int q = j < a.n ? clamp_bag(r.seg, a.nbags) : a.nbags;
      int p = __shfl_up_sync(~0u, q, 1);
      if (lane == 0) p = carry;
      const bool change = j == start || q != p;
      const bool stop = ended || j >= a.n ||
                        (j > start && change &&
                         (j >= s1 || q < 0 || q >= a.nbags));
      const unsigned stops = __ballot_sync(~0u, stop);
      const bool past = stops && lane >= __ffs(stops) - 1;
      bool from_c = false, cold = false;
      long long code = -1;
      float scale = 0.f;
      if constexpr (kCold != 0) {
        cold = !past && !r.use_c && r.use_cold;
        if (cold) code = kColdBase + r.m;
        if constexpr (kCold == adapm::kWireI8)
          scale = cold ? __ldg(a.cold_scale + r.m) : 0.f;
      }
      if (!cold && !past) {
        const long long src = routed_source<true>(
            &r.o_sh, &r.o_sl, &r.c_sh, &r.c_sl, &r.use_c, 0, a.shards,
            a.slots, a.c_shards, a.c_slots, a.W, &from_c);
        code = src < 0 ? -1 : (from_c ? -2 - src : src);
      }
      if constexpr (kCold != 0) {
        sm.meta[buf][lane] =
            ColdMeta{code, past ? -1 : q + (change ? kFirst : 0), scale};
      } else {
        sm.code[buf][lane] = code;
        sm.bag[buf][lane] = past ? -1 : q;
        sm.first[buf][lane] = change;
      }
      carry = __shfl_sync(~0u, q, 31);
      ended = ended || stops != 0;
    };
    RawOf<kCold> next = load_raw<kCold>(a, start + 32 + lane);
    resolve(start, load_raw<kCold>(a, start + lane), 0);
    __syncwarp();
    T acc = zero<T>();
    int cur = -1;                         // the bag being folded
    long long cur_lo = 0;                 // its first position
    long long j = start;
    auto flush = [&]() {                  // bag cur ends before j
      if (cur >= 0 && col) {
        const T v = a.mean ? div_rn(acc, (float)(j - cur_lo)) : acc;
        __stcs(out + (long long)cur * a.W + c, v);
      }
    };
    if constexpr (kCold != 0) {
      // K10: a member's resolved record is read from shared memory once,
      // at its issue, and held in registers until its fold (slot d, the
      // member's position mod kDepth, which is also its ring stage: both
      // fixed at compile time); the next record's read comes before the
      // wait. Per member: one shared read of a record, one of its value,
      // one copy issued.
      static_assert(32 % kDepth == 0, "a batch holds whole ring rounds");
      auto issue = [&](const ColdMeta& m, int st) {
        if (m.bag >= 0 && col) {
          if (m.code >= kColdBase)
            cold_issue<T, kCold>(&sm.ring[st][0][lane], a,
                                 m.code - kColdBase, c);
          else if (m.code >= 0)
            cp_async(&sm.ring[st][0][lane], main_pool + m.code + c);
          else if (m.code <= -2) {
            cp_async(&sm.ring[st][0][lane], cache + (-2 - m.code) + c);
            cp_async(&sm.ring[st][1][lane], delta + (-2 - m.code) + c);
          }
          if (m.bag >= kFirst)
            cp_async(&sm.ring[st][2][lane],
                     out + (long long)(m.bag - kFirst) * a.W + c);
        }
        cp_commit();                      // one group per member, always
      };
      // routed_value of member m at ring stage d (a cold member decoded)
      auto value = [&](const ColdMeta& m, int d) {
        return m.code >= kColdBase
                   ? cold_value<T, kCold>(sm.ring[d][0][lane], m.scale)
               : m.code == -1 ? zero<T>()
               : m.code >= 0  ? sm.ring[d][0][lane]
                              : add_rn(sm.ring[d][0][lane],
                                       sm.ring[d][1][lane]);
      };
      ColdMeta held[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        held[d] = sm.meta[0][d];
        issue(held[d], d);
      }
      for (long long base = start;; base += 32) {
        const int buf = (int)(((base - start) >> 5) & 1);
        resolve(base + 32, next, buf ^ 1);
        if (!ended) next = load_raw<kCold>(a, base + 64 + lane);
        __syncwarp();
        bool done = false;
        for (int i0 = 0; i0 < 32 && !done; i0 += kDepth) {
#pragma unroll
          for (int d = 0; d < kDepth; ++d) {
            const int k = i0 + d + kDepth;  // the member kDepth ahead
            const ColdMeta next_m = sm.meta[k < 32 ? buf : buf ^ 1][k & 31];
            const ColdMeta m = held[d];   // member j's
            if (m.bag < 0) {
              done = true;
              break;
            }
            cp_wait<kDepth - 1>();        // member j's group has landed
            if (m.bag >= kFirst) {
              flush();
              cur = m.bag - kFirst;
              cur_lo = j;
              acc = sm.ring[d][2][lane];
            }
            acc = add_rn(acc, value(m, d));
            issue(next_m, d);
            held[d] = next_m;
            ++j;
          }
        }
        if (done) break;
        __syncwarp();                     // buf is rewritten next round
      }
    } else {
      // issue the loads of member (buf, i) into ring stage st
      auto issue = [&](int buf, int i, int st) {
        const int bag = sm.bag[buf][i];
        if (bag >= 0 && col) {
          const long long code = sm.code[buf][i];
          if (code >= 0) {
            cp_async(&sm.ring[st][0][lane], main_pool + code + c);
          } else if (code <= -2) {
            cp_async(&sm.ring[st][0][lane], cache + (-2 - code) + c);
            cp_async(&sm.ring[st][1][lane], delta + (-2 - code) + c);
          }
          if (sm.first[buf][i])
            cp_async(&sm.ring[st][2][lane], out + (long long)bag * a.W + c);
        }
        cp_commit();                      // one group per member, always
      };
#pragma unroll
      for (int d = 0; d < kDepth; ++d) issue(0, d, d);
      int st = 0;                         // member j's ring stage
      for (long long base = start;; base += 32) {
        const int buf = (int)(((base - start) >> 5) & 1);
        resolve(base + 32, next, buf ^ 1);
        if (!ended) next = load_raw<kCold>(a, base + 64 + lane);
        __syncwarp();
        bool done = false;
        for (int i = 0; i < 32; ++i, ++j) {
          const int bag = sm.bag[buf][i];
          if (bag < 0) {
            done = true;
            break;
          }
          cp_wait<kDepth - 1>();        // member j's group has landed
          const long long code = sm.code[buf][i];
          if (sm.first[buf][i]) {
            flush();
            cur = bag;
            cur_lo = j;
            acc = sm.ring[st][2][lane];
          }
          // routed_value: the main read as loaded, cache+delta as one
          // rounded add, +0 for a zero row
          const T v = code == -1 ? zero<T>()
                      : code >= 0 ? sm.ring[st][0][lane]
                                  : add_rn(sm.ring[st][0][lane],
                                           sm.ring[st][1][lane]);
          acc = add_rn(acc, v);
          const int k = i + kDepth;     // the member kDepth ahead
          issue(k < 32 ? buf : buf ^ 1, k & 31, st);
          st = st + 1 == kDepth ? 0 : st + 1;
        }
        if (done) break;
        __syncwarp();                     // buf is rewritten next round
      }
    }
    flush();
    cp_wait<0>();
    __syncwarp();
  }
  if (a.slot >= 0 && lane == 0 &&
      atomicAdd(&g_done[a.slot], 1u) == gridDim.x * kWarps - 1) {
    g_next[a.slot] = 0;                   // the last warp: ready for the
    g_done[a.slot] = 0;                   // stream's next launch
  }
}

// The counter slot of `stream`, or -1 once kSlots streams have one.
int stream_slot(cudaStream_t stream) {
  static std::mutex mu;
  static cudaStream_t seen[kSlots];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (seen[i] == stream) return i;
  if (used == kSlots) return -1;
  seen[used] = stream;
  return used++;
}

template <typename T, int kCold>
int launch(const T* main_pool, const T* cache, const T* delta, T* out,
           Args a, cudaStream_t stream) {
  // the persistent grid: as many CTAs as fit on the card at once
  static int grid_cap = 0;
  const int smem = kWarps * (int)sizeof(SmemOf<T, kCold>);
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_pool_kernel<T, kCold>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_pool_kernel<T, kCold>, kWarps * 32, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap = sms * per_sm;
  }
  const long long want = (a.items + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < grid_cap ? want : grid_cap);
  a.slot = a.items > (long long)blocks * kWarps ? stream_slot(stream) : -1;
  gather_pool_kernel<T, kCold><<<blocks, kWarps * 32, smem, stream>>>(
      main_pool, cache, delta, out, a);
  return (int)cudaGetLastError();
}

template <int kCold>
int launch_vec(int vec, const float* main_pool, const float* cache,
               const float* delta, float* out, const Args& a,
               cudaStream_t stream) {
  if (vec)
    return launch<float4, kCold>(reinterpret_cast<const float4*>(main_pool),
                                 reinterpret_cast<const float4*>(cache),
                                 reinterpret_cast<const float4*>(delta),
                                 reinterpret_cast<float4*>(out), a, stream);
  return launch<float, kCold>(main_pool, cache, delta, out, a, stream);
}

Args make_args(const int* o_sh, const int* o_sl, const int* c_sh,
               const int* c_sl, const unsigned char* use_c, const int* seg,
               const long long* perm, long long n, int nbags, int shards,
               int slots, int c_shards, int c_slots, int L, int W,
               int mean) {
  Args a{o_sh,  o_sl,   c_sh,     c_sl,    use_c, seg, perm, n, nbags,
         shards, slots, c_shards, c_slots, W,     mean, (W + 31) / 32, 0,
         0,      -1,    nullptr,  nullptr, nullptr, L};
  a.span_items = (n / kSpan + 1) * a.slices;
  a.items = a.span_items +
            (mean ? (nbags + kChunk - 1) / kChunk * (long long)a.slices : 0);
  return a;
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
  const int W = vec ? L / 4 : L;
  const Args a = make_args(o_sh, o_sl, c_sh, c_sl, use_c, seg, perm, n,
                           nbags, shards, slots, c_shards, c_slots, L, W,
                           mean);
  return launch_vec<0>(vec, main_pool, cache, delta, out, a, stream);
}

// K10: adapm_gather_pool with cold members. cold is the batch's staged
// [n, L] wire buffer (indexed by member, as the coordinates are) in
// `wire` format (1 f32, 2 f16, 3 int8 with cold_scale [n] f32), use_cold
// [n] marks the members read from it. vec also needs cold aligned.
extern "C" int adapm_gather_pool_cold(
    const float* main_pool, const float* cache, const float* delta,
    const int* o_sh, const int* o_sl, const int* c_sh, const int* c_sl,
    const unsigned char* use_c, const void* cold, const float* cold_scale,
    const unsigned char* use_cold, const int* seg, const long long* perm,
    long long n, float* out, int nbags, int shards, int slots, int c_shards,
    int c_slots, int L, int mean, int wire, int vec, cudaStream_t stream) {
  if (cache == nullptr || delta == nullptr || use_cold == nullptr ||
      (wire == adapm::kWireI8 && cold_scale == nullptr) || nbags >= kFirst)
    return (int)cudaErrorInvalidValue;
  if (nbags <= 0) return 0;
  const int W = vec ? L / 4 : L;
  Args a = make_args(o_sh, o_sl, c_sh, c_sl, use_c, seg, perm, n, nbags,
                     shards, slots, c_shards, c_slots, L, W, mean);
  a.cold = cold;
  a.cold_scale = cold_scale;
  a.use_cold = use_cold;
  switch (wire) {
    case adapm::kWireF32:
      return launch_vec<adapm::kWireF32>(vec, main_pool, cache, delta, out,
                                         a, stream);
    case adapm::kWireF16:
      return launch_vec<adapm::kWireF16>(vec, main_pool, cache, delta, out,
                                         a, stream);
    case adapm::kWireI8:
      return launch_vec<adapm::kWireI8>(vec, main_pool, cache, delta, out,
                                        a, stream);
  }
  return (int)cudaErrorInvalidValue;
}
