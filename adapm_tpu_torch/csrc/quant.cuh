// The wire formats of the tiered cold store and of compressed sync
// rounds, on the card: shared by K9 gather_cold, K10 gather_pool_cold
// (gather_pool.cu), K11 write_main_rows and K12 sync_compress.
//
// Bit for bit the host twins of adapm_tpu_torch/tier/quant.py (and the
// JAX package's XLA programs device/jaxport.py _gather_cold_*,
// _write_main_rows_*, _sync_replicas_compressed):
//
//   fp32  the row as stored;
//   fp16  __half2float of the stored half (exact);
//   int8  (float)q * scale, one IEEE f32 multiply (__fmul_rn: nvcc may
//         not contract it into an FMA with a later add).
//
// Quantizing (K12): fp16 clips to +-65504 (keeping NaN and -0.0, as
// jnp.clip does) and rounds to nearest even (__float2half_rn); int8
// takes s = f16(clip(max|x| / 127, 0, 65504)) with an IEEE division
// (__fdiv_rn), q = clip(rint(x / (s > 0 ? s : 1)), -127, 127) with
// round-half-to-even (rintf, as numpy's round and XLA's; roundf rounds
// halves away from zero), and ships (float)(int8)q * s: the int8 round
// trip turns a -0.0 quotient into +0.0, as the JAX program's astype
// does.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace adapm {

constexpr float kF16Max = 65504.0f;   // tier/quant.py F16_MAX

// wire modes (template parameters)
constexpr int kWireF32 = 1;
constexpr int kWireF16 = 2;
constexpr int kWireI8 = 3;

// jnp.clip / np.clip: NaN stays NaN, -0.0 stays -0.0
__device__ __forceinline__ float clip_keep_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float f16_round_trip(float x) {
  return __half2float(__float2half_rn(x));
}

// the int8 scale of a row whose max-abs is m
__device__ __forceinline__ float int8_scale(float m) {
  return f16_round_trip(clip_keep_nan(__fdiv_rn(m, 127.f), 0.f, kF16Max));
}

// one element shipped in `kWire` format (fp16 or int8 with scale s)
template <int kWire>
__device__ __forceinline__ float quantize_value(float x, float s) {
  if (kWire == kWireF16) return f16_round_trip(clip_keep_nan(x, -kF16Max,
                                                             kF16Max));
  const float safe = s > 0.f ? s : 1.f;
  const float q = clip_keep_nan(rintf(__fdiv_rn(x, safe)), -127.f, 127.f);
  return __fmul_rn((float)(signed char)(int)q, s);
}

// The dequantized value of column c (in elements of T: float, or float4
// of four consecutive floats) of wire row k of a [rows, L] buffer `q`.
template <typename T, int kWire>
__device__ __forceinline__ T wire_load(const void* q, float s, long long k,
                                       int L, int c);

template <>
__device__ __forceinline__ float wire_load<float, kWireF32>(
    const void* q, float, long long k, int L, int c) {
  return __ldg(reinterpret_cast<const float*>(q) + k * L + c);
}
template <>
__device__ __forceinline__ float wire_load<float, kWireF16>(
    const void* q, float, long long k, int L, int c) {
  return __half2float(reinterpret_cast<const __half*>(q)[k * L + c]);
}
template <>
__device__ __forceinline__ float wire_load<float, kWireI8>(
    const void* q, float s, long long k, int L, int c) {
  return __fmul_rn((float)reinterpret_cast<const signed char*>(q)[k * L + c],
                   s);
}
template <>
__device__ __forceinline__ float4 wire_load<float4, kWireF32>(
    const void* q, float, long long k, int L, int c) {
  return __ldg(reinterpret_cast<const float4*>(q) + k * (L / 4) + c);
}

// four halves (8 bytes) or four int8 (4 bytes) as a float4
__device__ __forceinline__ float4 decode_f16x4(uint2 u) {
  const __half2 a = *reinterpret_cast<const __half2*>(&u.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ float4 decode_i8x4(unsigned u, float s) {
  const char4 v = *reinterpret_cast<const char4*>(&u);
  return make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                     __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
}

template <>
__device__ __forceinline__ float4 wire_load<float4, kWireF16>(
    const void* q, float, long long k, int L, int c) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(
      reinterpret_cast<const __half*>(q) + k * L + 4 * c));
  return decode_f16x4(u);
}
template <>
__device__ __forceinline__ float4 wire_load<float4, kWireI8>(
    const void* q, float s, long long k, int L, int c) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(
      reinterpret_cast<const signed char*>(q) + k * L + 4 * c));
  return decode_i8x4(u, s);
}

}  // namespace adapm
