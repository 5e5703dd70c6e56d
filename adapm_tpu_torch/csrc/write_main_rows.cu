// K11 write_main_rows: the promotion upload of a tiered store — wire
// rows dequantized straight into the device-hot main pool.
//
// Replaces the XLA programs adapm_tpu/device/jaxport.py
// _write_main_rows, _write_main_rows_fp16 and _write_main_rows_int8
// (jaxport.py:368-382): main.at[sh, row].set(deq(q), mode="drop"),
// where q is [b, L] in f32, f16 or int8 with a [b] f32 scale and deq is
// quant.cuh's (bit for bit tier/quant.py dequantize_rows).
//
// drop_set's contract (device/torchport.py): out-of-range entries drop
// and, of several entries naming one row, the last in batch order wins.
// The wrapper resolves the winners before the launch (as drop_set
// does: a flat target per entry and one stable sort) and hands over the
// sorted targets, the entry at each sorted position and a mask of the
// winners (so nothing waits for the card to size the work); the kernel
// writes each target row once and its writes never race. Promotion
// (tier/promote.py promote_rows) allocates distinct hot rows, so there
// every entry wins.
//
// Bound on an H100: bytes (each winner's wire row read once, its f32
// row written once). Design: a grid-stride loop of one thread per
// (sorted entry, four columns): a winner's thread writes 16 bytes and
// reads 16, 8 or 4.
// The pool is never reallocated: a captured CUDA graph holds its
// address (ops/fused.py DeviceRoutedRunner.run_scan).
#include <cuda_runtime.h>

#include "quant.cuh"

namespace {

using adapm::wire_load;

constexpr int kThreads = 256;

template <typename T, int kWire>
__global__ void __launch_bounds__(kThreads) write_rows_kernel(
    T* __restrict__ pool, const long long* __restrict__ tgt,
    const long long* __restrict__ src, const unsigned char* __restrict__ win,
    const void* q, const float* __restrict__ scale, long long m, int W,
    int L) {
  const long long total = m * W;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long e = t / W;
    if (!__ldg(win + e)) continue;
    const int c = (int)(t - e * W);
    const long long k = __ldg(src + e);
    const float s = kWire == adapm::kWireI8 ? __ldg(scale + k) : 0.f;
    __stcs(pool + __ldg(tgt + e) * W + c, wire_load<T, kWire>(q, s, k, L, c));
  }
}

template <typename T, int kWire>
int launch(T* pool, const long long* tgt, const long long* src,
           const unsigned char* win, const void* q, const float* scale,
           long long m, int W, int L, cudaStream_t stream) {
  const long long total = m * W;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  write_rows_kernel<T, kWire><<<(unsigned)blocks, kThreads, 0, stream>>>(
      pool, tgt, src, win, q, scale, m, W, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int wire, T* pool, const long long* tgt, const long long* src,
             const unsigned char* win, const void* q, const float* scale,
             long long m, int W, int L, cudaStream_t stream) {
  switch (wire) {
    case adapm::kWireF32:
      return launch<T, adapm::kWireF32>(pool, tgt, src, win, q, scale, m,
                                        W, L, stream);
    case adapm::kWireF16:
      return launch<T, adapm::kWireF16>(pool, tgt, src, win, q, scale, m,
                                        W, L, stream);
    case adapm::kWireI8:
      return launch<T, adapm::kWireI8>(pool, tgt, src, win, q, scale, m,
                                       W, L, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// pool: the main pool as [rows, L] f32; m sorted entries, each winner
// (win[e]) writing wire row src[e] of q ([b, L] in `wire` format: 1 f32,
// 2 f16, 3 int8 with scale [b] f32) to pool row tgt[e]. vec: L % 4 == 0,
// pool and q 16-byte aligned.
extern "C" int adapm_write_main_rows(float* pool, const long long* tgt,
                                     const long long* src,
                                     const unsigned char* win, const void* q,
                                     const float* scale, long long m, int L,
                                     int wire, int vec, cudaStream_t stream) {
  if (m <= 0) return 0;
  if (wire == adapm::kWireI8 && scale == nullptr)
    return (int)cudaErrorInvalidValue;
  if (vec)
    return dispatch<float4>(wire, reinterpret_cast<float4*>(pool), tgt, src,
                            win, q, scale, m, L / 4, L, stream);
  return dispatch<float>(wire, pool, tgt, src, win, q, scale, m, L, L,
                         stream);
}
