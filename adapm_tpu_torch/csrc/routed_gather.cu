// K1 routed_gather: the routed fill-gather every Pull and fused-step
// read goes through.
//
// Replaces the TPU kernel adapm_tpu/ops/pallas_kernels.py gather_rows
// (a block-row gather with scalar-prefetched indices), generalized to
// the routed read the JAX package runs as an XLA program
// (device/jaxport.py _gather, ops/fused.py _read_rows):
//
//   out[i] = use_c[i] ? fill(cache)[c_sh[i], c_sl[i]] + fill(delta)[c_sh[i], c_sl[i]]
//                     : fill(main)[o_sh[i], o_sl[i]]
//
// where fill() reads 0 for any out-of-range coordinate (negative or
// past the pool; the OOB padding sentinel is 2^31-2). The choice is a
// select, never an add, so -0.0 survives a main read; cache+delta is
// one IEEE f32 add (__fadd_rn: no contraction), as in the JAX program.
// With cache == nullptr the kernel is the main-only form (the
// no-replica step variant and every plain fill-gather of a pool).
//
// Bound on an H100: bytes. Each output row reads one (or two) pool rows
// and writes one row; there is no arithmetic to speak of. Design: one
// warp per output row, 16-byte vector loads along the row when the row
// length allows them, so a warp moves 512 contiguous bytes per step.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per 256-thread block

__device__ __forceinline__ const float* row_or_null(
    const float* pool, int sh, int sl, int shards, int slots, int L) {
  if (pool == nullptr || sh < 0 || sh >= shards || sl < 0 || sl >= slots)
    return nullptr;
  return pool + ((long long)sh * slots + sl) * (long long)L;
}

template <bool kVec>
__global__ void routed_gather_kernel(
    const float* __restrict__ main_pool, const float* __restrict__ cache,
    const float* __restrict__ delta, const int* __restrict__ o_sh,
    const int* __restrict__ o_sl, const int* __restrict__ c_sh,
    const int* __restrict__ c_sl, const unsigned char* __restrict__ use_c,
    float* __restrict__ out, long long n, int shards, int slots,
    int c_shards, int c_slots, int L) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const float* a;
  const float* b = nullptr;
  if (use_c != nullptr && use_c[row]) {
    a = row_or_null(cache, c_sh[row], c_sl[row], c_shards, c_slots, L);
    if (a != nullptr) b = delta + (a - cache);
  } else {
    a = row_or_null(main_pool, o_sh[row], o_sl[row], shards, slots, L);
  }
  float* o = out + row * (long long)L;
  if (kVec) {
    const int L4 = L >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int c = lane; c < L4; c += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a != nullptr) {
        v = __ldg(a4 + c);
        if (b != nullptr) {
          const float4 w = __ldg(b4 + c);
          v.x = __fadd_rn(v.x, w.x);
          v.y = __fadd_rn(v.y, w.y);
          v.z = __fadd_rn(v.z, w.z);
          v.w = __fadd_rn(v.w, w.w);
        }
      }
      o4[c] = v;
    }
  } else {
    for (int c = lane; c < L; c += 32) {
      float v = 0.f;
      if (a != nullptr) {
        v = __ldg(a + c);
        if (b != nullptr) v = __fadd_rn(v, __ldg(b + c));
      }
      o[c] = v;
    }
  }
}

}  // namespace

extern "C" int adapm_routed_gather(
    const float* main_pool, const float* cache, const float* delta,
    const int* o_sh, const int* o_sl, const int* c_sh, const int* c_sl,
    const unsigned char* use_c, float* out, long long n, int shards,
    int slots, int c_shards, int c_slots, int L, int vec,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (vec)
    routed_gather_kernel<true><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
        main_pool, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c, out, n,
        shards, slots, c_shards, c_slots, L);
  else
    routed_gather_kernel<false><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
        main_pool, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c, out, n,
        shards, slots, c_shards, c_slots, L);
  return (int)cudaGetLastError();
}
