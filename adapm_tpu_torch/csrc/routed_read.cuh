// The routed read of one row, shared by K1 (routed_gather.cu) and K8
// (gather_pool.cu), so both read a member row alike, instruction for
// instruction (the JAX program device/jaxport.py _gather):
//
//   row = use_c ? fill(cache)[c_sh, c_sl] + fill(delta)[c_sh, c_sl]
//               : fill(main)[o_sh, o_sl]
//
// fill() reads 0 for any out-of-range coordinate (negative or past the
// pool; the OOB padding sentinel is 2^31-2). The choice is a select,
// never an add, so -0.0 survives a main read; cache+delta is one IEEE
// f32 add (__fadd_rn: no contraction). A caller resolves the source
// once per row (routed_source), issues the loads of a column
// (routed_load) for several rows before it combines any (routed_value),
// so its loads are in flight together.
#pragma once

#include <cuda_runtime.h>

namespace adapm {

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// A load that asks L2 to keep its line (evict_last): K1 reads a pool row's
// column slab again for each repeat of the row in its batch.
__device__ __forceinline__ float4 ldg_keep(const float4* p) {
  float4 v;
  asm("{ .reg .b64 pol; createpolicy.fractional.L2::evict_last.b64 pol, "
      "1.0; ld.global.nc.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], pol; }"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p)
      : "memory");
  return v;
}

__device__ __forceinline__ float ldg_keep(const float* p) {
  float v;
  asm("{ .reg .b64 pol; createpolicy.fractional.L2::evict_last.b64 pol, "
      "1.0; ld.global.nc.L2::cache_hint.f32 %0, [%1], pol; }"
      : "=f"(v)
      : "l"(p)
      : "memory");
  return v;
}

template <bool kKeep, typename T>
__device__ __forceinline__ T ldg_row(const T* p) {
  if constexpr (kKeep)
    return ldg_keep(p);
  else
    return __ldg(p);
}

// Entry k's source: the offset, in elements of T (W per row), of its row
// in the pool it reads, or -1 for a zero row; *from_c is set when that
// pool is cache+delta. kFull: the cache+delta form (else main only).
template <bool kFull>
__device__ __forceinline__ long long routed_source(
    const int* o_sh, const int* o_sl, const int* c_sh, const int* c_sl,
    const unsigned char* use_c, long long k, int shards, int slots,
    int c_shards, int c_slots, int W, bool* from_c) {
  *from_c = false;
  if (kFull && use_c[k]) {
    *from_c = true;
    const int sh = c_sh[k], sl = c_sl[k];
    if (sh >= 0 && sh < c_shards && sl >= 0 && sl < c_slots)
      return ((long long)sh * c_slots + sl) * W;
    return -1;
  }
  const int sh = o_sh[k], sl = o_sl[k];
  if (sh >= 0 && sh < shards && sl >= 0 && sl < slots)
    return ((long long)sh * slots + sl) * W;
  return -1;
}

// The loads of column c of a row whose source is `src` (zeros for a
// zero row): *a from main or cache, *b from delta (zero unless kFull).
// kKeep: the loads ask L2 to keep their lines (ldg_keep).
template <typename T, bool kFull, bool kKeep = false>
__device__ __forceinline__ void routed_load(
    const T* __restrict__ main_pool, const T* __restrict__ cache,
    const T* __restrict__ delta, long long src, bool from_c, int c, T* a,
    T* b) {
  *a = zero<T>();
  *b = zero<T>();
  if (src < 0) return;
  if (kFull && from_c) {
    *a = ldg_row<kKeep>(cache + src + c);
    *b = ldg_row<kKeep>(delta + src + c);
  } else {
    *a = ldg_row<kKeep>(main_pool + src + c);
  }
}

// The row's value from its loads: the main read as loaded, or
// cache+delta as one rounded add.
template <typename T, bool kFull>
__device__ __forceinline__ T routed_value(T a, T b, long long src,
                                          bool from_c) {
  return (kFull && from_c && src >= 0) ? add_rn(a, b) : a;
}

}  // namespace adapm
