// K9 gather_cold: the routed read of a tiered store, where an owner row
// may live in the host cold store and arrives staged beside the batch.
//
// Replaces the XLA programs adapm_tpu/device/jaxport.py _gather_cold,
// _gather_cold_fp16 and _gather_cold_int8 (jaxport.py:256, :315, :328):
//
//   m[i]   = use_cold[i] ? deq(cold)[i] : fill(main)[o_sh[i], o_row[i]]
//   out[i] = use_c[i] ? fill(cache)[c_sh, c_sl] + fill(delta)[c_sh, c_sl]
//                     : m[i]
//
// where cold is the staged [n, L] wire buffer of the batch (row i
// belongs to entry i; only cold entries' rows are read) in f32, f16, or
// int8 with a [n] f32 scale, dequantized as quant.cuh does (bit for bit
// tier/quant.py dequantize_rows). Both choices are selects, so -0.0
// survives; out-of-range coordinates read 0; cache+delta is one rounded
// add. The wire mode is a template parameter.
//
// Bound on an H100: bytes (one or two pool rows, or one wire row, read
// per entry; one row written). Design: K1's (routed_gather.cu) — each
// warp moves two rows, its first lanes resolve the rows' sources (and
// load a cold row's scale), then the warp issues every load of both
// rows before the first store. A cold row is read from the staging
// buffer, 16 bytes (f32), 8 (f16) or 4 (int8) a lane per four columns.
#include <cuda_runtime.h>

#include "quant.cuh"
#include "routed_read.cuh"

namespace {

using adapm::routed_load;
using adapm::routed_source;
using adapm::routed_value;
using adapm::wire_load;

constexpr int kWarps = 8;    // warps per block
constexpr int kRows = 2;     // rows per warp, in flight together
constexpr int kNV = 4;       // elements per lane per column block

struct Args {
  const int *o_sh, *o_row, *c_sh, *c_sl;
  const unsigned char *use_c, *use_cold;
  const void* cold;
  const float* scale;
  long long n;
  int shards, rows, c_shards, c_slots, W, L;
};

template <typename T, int kWire>
__global__ void __launch_bounds__(kWarps * 32) gather_cold_kernel(
    const T* __restrict__ main_pool, const T* __restrict__ cache,
    const T* __restrict__ delta, T* __restrict__ out, Args a) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kRows;
  // lane g < kRows resolves row r0 + g: a pool row offset (-1: a zero
  // row), or cold (the staging row is the entry's own)
  long long src = -2;                         // -2: past the batch
  bool from_c = false, cold = false;
  float s = 0.f;
  const long long r = r0 + lane;
  if (lane < kRows && r < a.n) {
    if (!a.use_c[r] && a.use_cold[r]) {
      cold = true;
      src = -1;
      if (kWire == adapm::kWireI8) s = __ldg(a.scale + r);
    } else {
      src = routed_source<true>(a.o_sh, a.o_row, a.c_sh, a.c_sl, a.use_c, r,
                                a.shards, a.rows, a.c_shards, a.c_slots,
                                a.W, &from_c);
    }
  }
  long long gsrc[kRows];
  bool gc[kRows], gcold[kRows];
  float gs[kRows];
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
    gsrc[g] = __shfl_sync(~0u, src, g);
    gc[g] = __shfl_sync(~0u, (int)from_c, g) != 0;
    gcold[g] = __shfl_sync(~0u, (int)cold, g) != 0;
    gs[g] = __shfl_sync(~0u, s, g);
  }
  for (int cb = 0; cb < a.W; cb += 32 * kNV) {
    T va[kRows][kNV];
    T vb[kRows][kNV];
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = cb + k * 32 + lane;
        if (c >= a.W || gsrc[g] == -2) continue;
        if (gcold[g]) {
          va[g][k] = wire_load<T, kWire>(a.cold, gs[g], r0 + g, a.L, c);
          vb[g][k] = adapm::zero<T>();
        } else {
          routed_load<T, true>(main_pool, cache, delta, gsrc[g], gc[g], c,
                               &va[g][k], &vb[g][k]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (gsrc[g] == -2) continue;
      T* o = out + (r0 + g) * (long long)a.W;
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = cb + k * 32 + lane;
        if (c >= a.W) continue;
        __stcs(o + c, gcold[g] ? va[g][k]
                               : routed_value<T, true>(va[g][k], vb[g][k],
                                                       gsrc[g], gc[g]));
      }
    }
  }
}

template <typename T, int kWire>
int launch(const T* main_pool, const T* cache, const T* delta, T* out,
           const Args& a, cudaStream_t stream) {
  const long long per_block = (long long)kWarps * kRows;
  const unsigned blocks = (unsigned)((a.n + per_block - 1) / per_block);
  gather_cold_kernel<T, kWire><<<blocks, kWarps * 32, 0, stream>>>(
      main_pool, cache, delta, out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int wire, const T* main_pool, const T* cache, const T* delta,
             T* out, const Args& a, cudaStream_t stream) {
  switch (wire) {
    case adapm::kWireF32:
      return launch<T, adapm::kWireF32>(main_pool, cache, delta, out, a,
                                        stream);
    case adapm::kWireF16:
      return launch<T, adapm::kWireF16>(main_pool, cache, delta, out, a,
                                        stream);
    case adapm::kWireI8:
      return launch<T, adapm::kWireI8>(main_pool, cache, delta, out, a,
                                       stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// n entries; out is [n, L]. cold is [n, L] in the wire format `wire`
// (1 f32, 2 f16, 3 int8 with scale [n] f32; scale may be null
// otherwise). vec: L % 4 == 0 and every pool, cold and out 16-byte
// aligned.
extern "C" int adapm_gather_cold(
    const float* main_pool, const float* cache, const float* delta,
    const int* o_sh, const int* o_row, const int* c_sh, const int* c_sl,
    const unsigned char* use_c, const void* cold, const float* scale,
    const unsigned char* use_cold, long long n, float* out, int shards,
    int rows, int c_shards, int c_slots, int L, int wire, int vec,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (wire == adapm::kWireI8 && scale == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{o_sh, o_row, c_sh, c_sl, use_c, use_cold, cold, scale, n,
         shards, rows, c_shards, c_slots, vec ? L / 4 : L, L};
  if (vec)
    return dispatch<float4>(wire, reinterpret_cast<const float4*>(main_pool),
                            reinterpret_cast<const float4*>(cache),
                            reinterpret_cast<const float4*>(delta),
                            reinterpret_cast<float4*>(out), a, stream);
  return dispatch<float>(wire, main_pool, cache, delta, out, a, stream);
}
