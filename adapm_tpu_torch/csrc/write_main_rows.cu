// K11 write_main_rows: the promotion upload of a tiered store — wire
// rows dequantized straight into the device-hot main pool.
//
// Replaces the XLA programs adapm_tpu/device/jaxport.py
// _write_main_rows, _write_main_rows_fp16 and _write_main_rows_int8
// (jaxport.py:368-382): main.at[sh, row].set(deq(q), mode="drop"),
// where q is [b, L] in f32, f16 or int8 with a [b] f32 scale and deq is
// quant.cuh's (bit for bit tier/quant.py dequantize_rows).
//
// drop_set's contract (device/torchport.py): an entry whose sh is
// outside [0, S) or whose row is outside [0, R) (negative included)
// drops and, of several entries naming one row, the last in batch order
// wins. Promotion (tier/promote.py promote_rows) allocates distinct hot
// rows and pads with OOB, so there every in-range entry wins; the
// kernel keeps the general contract all the same.
//
// Bound on an H100: bytes (each winner's wire row read once, its f32
// row written once; the coordinates). The wrapper used to resolve the
// winners with torch ops before the launch (flat targets, a stable
// sort, a mask): some ten small kernels that took ten times the write.
// Here the card resolves them in two launches of one call, and the
// wrapper passes the int32 coordinates as they are:
//
// - claim: one thread an entry; an in-range entry e takes
//   atomicMax(&claim[t], e) on an int32 scratch of one word per pool
//   row (t = sh * R + row), so claim[t] ends as the last entry naming t;
// - write: one warp an entry; lane 0 reads claim[t], and only the
//   entry that finds itself there writes the dequantized row (16-byte
//   streaming stores of float4 where L % 4 == 0) and then sets claim[t]
//   back to -1. A losing entry reads the winner's index or -1, never
//   its own, so the reset cannot make it write.
//
// After every call the scratch is all -1 again: the wrapper allocates
// it once (ops/kernels.py) and fills it no more. Calls on one stream
// run in order; the two launches of a call are enqueued under one lock,
// so no other call's launch on that stream falls between them.
// The pool is never reallocated: a captured CUDA graph holds its
// address (ops/fused.py DeviceRoutedRunner.run_scan).
#include <cuda_runtime.h>

#include <mutex>

#include "quant.cuh"

namespace {

using adapm::wire_load;

constexpr int kClaimThreads = 256;
constexpr int kWarps = 8;   // warps per CTA of the write, an entry each

__device__ __forceinline__ bool in_range(int s, int r, int S, int R) {
  return s >= 0 && s < S && r >= 0 && r < R;
}

__global__ void __launch_bounds__(kClaimThreads) claim_kernel(
    int* __restrict__ claim, const int* __restrict__ sh,
    const int* __restrict__ row, int m, int S, int R) {
  const int e = blockIdx.x * kClaimThreads + threadIdx.x;
  if (e >= m) return;
  const int s = __ldg(sh + e), r = __ldg(row + e);
  if (in_range(s, r, S, R)) atomicMax(claim + (long long)s * R + r, e);
}

template <typename T, int kWire>
__global__ void __launch_bounds__(kWarps * 32) write_rows_kernel(
    T* __restrict__ pool, int* __restrict__ claim,
    const int* __restrict__ sh, const int* __restrict__ row, const void* q,
    const float* __restrict__ scale, int m, int S, int R, int W, int L) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= m) return;                       // the whole warp
  const int s = __ldg(sh + e), r = __ldg(row + e);
  if (!in_range(s, r, S, R)) return;
  const long long t = (long long)s * R + r;
  // claim is written in this launch (the resets): a plain load, which
  // sees the winner's index or -1
  int won = 0;
  if (lane == 0) won = claim[t] == e;
  if (!__shfl_sync(~0u, won, 0)) return;
  const float sc = kWire == adapm::kWireI8 ? __ldg(scale + e) : 0.f;
  T* dst = pool + t * W;
#pragma unroll 4
  for (int c = lane; c < W; c += 32)
    __stcs(dst + c, wire_load<T, kWire>(q, sc, e, L, c));
  if (lane == 0) claim[t] = -1;
}

template <typename T, int kWire>
int launch(T* pool, int* claim, const int* sh, const int* row,
           const void* q, const float* scale, int m, int S, int R, int W,
           int L, cudaStream_t stream) {
  claim_kernel<<<(m + kClaimThreads - 1) / kClaimThreads, kClaimThreads, 0,
                 stream>>>(claim, sh, row, m, S, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  write_rows_kernel<T, kWire><<<(m + kWarps - 1) / kWarps, kWarps * 32, 0,
                                stream>>>(pool, claim, sh, row, q, scale, m,
                                          S, R, W, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int wire, T* pool, int* claim, const int* sh, const int* row,
             const void* q, const float* scale, int m, int S, int R, int W,
             int L, cudaStream_t stream) {
  switch (wire) {
    case adapm::kWireF32:
      return launch<T, adapm::kWireF32>(pool, claim, sh, row, q, scale, m,
                                        S, R, W, L, stream);
    case adapm::kWireF16:
      return launch<T, adapm::kWireF16>(pool, claim, sh, row, q, scale, m,
                                        S, R, W, L, stream);
    case adapm::kWireI8:
      return launch<T, adapm::kWireI8>(pool, claim, sh, row, q, scale, m,
                                       S, R, W, L, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// pool: the main pool as [S, R, L] f32; m entries with int32
// coordinates sh, row, entry e writing wire row e of q ([m, L] in
// `wire` format: 1 f32, 2 f16, 3 int8 with scale [m] f32). claim: the
// int32 scratch of S * R words, all -1 before the call and after it.
// vec: L % 4 == 0, pool and q 16-byte aligned.
extern "C" int adapm_write_main_rows(float* pool, int* claim, const int* sh,
                                     const int* row, const void* q,
                                     const float* scale, int m, int S,
                                     int R, int L, int wire, int vec,
                                     cudaStream_t stream) {
  static std::mutex mu;   // a call's two launches stay adjacent
  if (m <= 0) return 0;
  if (claim == nullptr || (wire == adapm::kWireI8 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (vec)
    return dispatch<float4>(wire, reinterpret_cast<float4*>(pool), claim,
                            sh, row, q, scale, m, S, R, L / 4, L, stream);
  return dispatch<float>(wire, pool, claim, sh, row, q, scale, m, S, R, L,
                         L, stream);
}
