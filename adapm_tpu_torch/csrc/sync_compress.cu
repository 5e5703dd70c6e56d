// K12 sync_compress: the quantize-and-park half of a compressed sync
// round (--sys.sync.compress fp16|int8).
//
// Replaces the wire transform of the XLA program
// adapm_tpu/device/jaxport.py _sync_replicas_compressed (jaxport.py:140):
// per replica row i,
//
//   d        = fill(delta)[r_sh[i], r_cs[i]]
//   ship[i]  = max|d| >= threshold
//   shipped  = quant(d)       fp16: f16(clip(d, +-65504)); int8: the
//                             per-row scale and rounding of quant.cuh
//   resid    = d - shipped
//   new_d[i] = ship[i] ? resid : d          (held rows keep their delta)
//   norm     = max over shipped rows of |resid|
//
// bit for bit tier/quant.py compress_delta. The rest of the round is
// the port's other kernels, in the JAX program's order
// (device/torchport.py sync_replicas): K3 merges the shipped rows into
// the owners (held rows' coordinates made OOB), K1 re-gathers the fresh
// owner rows, and drop_set installs them as bases and new_d as deltas.
//
// Bound on an H100: bytes (each delta row read, two rows written). The
// norm is a max over non-negative floats, taken as an atomicMax on
// their bits (ordered as unsigned ints), so its result does not depend
// on the order the rows finish in. Design: one warp a row (grid-stride
// over rows); a first pass takes the max-abs, a second re-reads the row
// (from L1/L2) and writes both outputs.
#include <cuda_runtime.h>

#include "quant.cuh"
#include "routed_read.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float absmax(float a, float x) {
  return fmaxf(a, fabsf(x));
}
__device__ __forceinline__ float absmax(float a, float4 x) {
  return fmaxf(fmaxf(fmaxf(a, fabsf(x.x)), fabsf(x.y)),
               fmaxf(fabsf(x.z), fabsf(x.w)));
}

template <int kWire>
__device__ __forceinline__ float quant(float x, float s) {
  return adapm::quantize_value<kWire>(x, s);
}

// one element (or four): shipped value, new delta, running |resid| max
template <int kWire>
__device__ __forceinline__ void step(float x, float s, bool ship, float* q,
                                     float* nd, float* rmax) {
  *q = quant<kWire>(x, s);
  const float r = __fsub_rn(x, *q);
  *nd = ship ? r : x;
  if (ship) *rmax = fmaxf(*rmax, fabsf(r));
}
template <int kWire>
__device__ __forceinline__ void step(float4 x, float s, bool ship, float4* q,
                                     float4* nd, float* rmax) {
  step<kWire>(x.x, s, ship, &q->x, &nd->x, rmax);
  step<kWire>(x.y, s, ship, &q->y, &nd->y, rmax);
  step<kWire>(x.z, s, ship, &q->z, &nd->z, rmax);
  step<kWire>(x.w, s, ship, &q->w, &nd->w, rmax);
}

template <typename T, int kWire>
__global__ void __launch_bounds__(kWarps * 32) sync_compress_kernel(
    const T* __restrict__ delta, const int* __restrict__ r_sh,
    const int* __restrict__ r_cs, long long n, int shards, int slots, int W,
    float threshold, T* __restrict__ shipped, T* __restrict__ new_delta,
    unsigned char* __restrict__ ship_out, unsigned* resid_max) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  float rmax = 0.f;
  for (long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       i < n; i += nwarps) {
    const int sh = __ldg(r_sh + i), sl = __ldg(r_cs + i);
    const long long base = (sh >= 0 && sh < shards && sl >= 0 && sl < slots)
                               ? ((long long)sh * slots + sl) * W
                               : -1;
    float m = 0.f;
    for (int c = lane; c < W; c += 32)
      if (base >= 0) m = absmax(m, __ldg(delta + base + c));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    const bool ship = m >= threshold;
    const float s = kWire == adapm::kWireI8 ? adapm::int8_scale(m) : 0.f;
    for (int c = lane; c < W; c += 32) {
      T x = adapm::zero<T>();
      if (base >= 0) x = __ldg(delta + base + c);
      T q, nd;
      step<kWire>(x, s, ship, &q, &nd, &rmax);
      __stcs(shipped + i * W + c, q);
      __stcs(new_delta + i * W + c, nd);
    }
    if (lane == 0) ship_out[i] = ship;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    rmax = fmaxf(rmax, __shfl_xor_sync(~0u, rmax, o));
  if (lane == 0 && rmax > 0.f) atomicMax(resid_max, __float_as_uint(rmax));
}

template <typename T, int kWire>
int launch(const T* delta, const int* r_sh, const int* r_cs, long long n,
           int shards, int slots, int W, float threshold, T* shipped,
           T* new_delta, unsigned char* ship, unsigned* resid_max,
           cudaStream_t stream) {
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 132 * 8) blocks = 132 * 8;
  sync_compress_kernel<T, kWire><<<(unsigned)blocks, kWarps * 32, 0,
                                   stream>>>(
      delta, r_sh, r_cs, n, shards, slots, W, threshold, shipped, new_delta,
      ship, resid_max);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int wire, const T* delta, const int* r_sh, const int* r_cs,
             long long n, int shards, int slots, int W, float threshold,
             T* shipped, T* new_delta, unsigned char* ship,
             unsigned* resid_max, cudaStream_t stream) {
  if (wire == adapm::kWireF16)
    return launch<T, adapm::kWireF16>(delta, r_sh, r_cs, n, shards, slots, W,
                                      threshold, shipped, new_delta, ship,
                                      resid_max, stream);
  if (wire == adapm::kWireI8)
    return launch<T, adapm::kWireI8>(delta, r_sh, r_cs, n, shards, slots, W,
                                     threshold, shipped, new_delta, ship,
                                     resid_max, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// delta: the [shards, slots, L] f32 delta pool; n replica rows at
// (r_sh, r_cs). Writes shipped and new_delta ([n, L] f32), ship ([n]
// bool) and raises *resid_max (the bits of a non-negative f32, 0 on
// entry) to the round's max |resid|. wire: 2 fp16, 3 int8. vec:
// L % 4 == 0 and every buffer 16-byte aligned.
extern "C" int adapm_sync_compress(const float* delta, const int* r_sh,
                                   const int* r_cs, long long n, int shards,
                                   int slots, int L, float threshold,
                                   float* shipped, float* new_delta,
                                   unsigned char* ship, unsigned* resid_max,
                                   int wire, int vec, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (vec)
    return dispatch<float4>(wire, reinterpret_cast<const float4*>(delta),
                            r_sh, r_cs, n, shards, slots, L / 4, threshold,
                            reinterpret_cast<float4*>(shipped),
                            reinterpret_cast<float4*>(new_delta), ship,
                            resid_max, stream);
  return dispatch<float>(wire, delta, r_sh, r_cs, n, shards, slots, L,
                         threshold, shipped, new_delta, ship, resid_max,
                         stream);
}
