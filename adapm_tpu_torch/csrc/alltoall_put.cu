// K13 alltoall_put: one BSP exchange of the collective sync plane, HBM to
// HBM through CUDA IPC.
//
// Replaces the XLA all-to-all program that adapm_tpu/parallel/collective.py
// builds through adapm_tpu/device/jaxport.py compile_collective
// (jaxport.py:654): leaf[d] of every process's [P, B, ...] pytree lands
// in process d at position [self]. Here every process owns a receive
// slab, [2 parities][P sources][T bytes], allocated with raw cudaMalloc
// (cudaIpcGetMemHandle on a sub-allocation of a caching allocator would
// hand out its base block's handle, and the offset would be lost); its
// peers open it with cudaIpcOpenMemHandle. The caller packs the leaves of
// one exchange into one [P, T] byte buffer (leaf regions 16-byte aligned;
// parallel/exchange.py), and ONE launch writes row d of it to
// dst[d] + dst_off for every destination d: dst[d] is the peer's mapped
// slab, or this process's own slab for d == self (a handle cannot be
// opened in its own process, so the self bucket is a local copy).
//
//   dst[d][dst_off + i] = src[d * T + i]      for i < T, every d < P
//
// Bound on an H100: bytes (P*T read once, P*T written once). Design:
// grid (x, P), blockIdx.y picks the destination, each thread moves 16
// bytes per iteration over a grid stride of the row. The launch is
// ordered on the caller's stream; the caller synchronizes that stream
// before the barrier that tells the readers their slab is complete.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 132 SMs x 8 blocks

__global__ void __launch_bounds__(kThreads)
    put_kernel(const uint4* __restrict__ src,
               const unsigned long long* __restrict__ dst, long long row_vec,
               long long off_vec) {
  const int d = blockIdx.y;
  uint4* out = reinterpret_cast<uint4*>(dst[d]) + off_vec;
  const uint4* in = src + static_cast<long long>(d) * row_vec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < row_vec; i += stride)
    out[i] = __ldg(in + i);
}

}  // namespace

// src: [P, row_bytes] on the device; dst: a device array of P pointers
// (each a slab base); dst_off: the byte offset of this exchange's bucket
// inside every slab. row_bytes and dst_off must be multiples of 16, and
// src and every dst 16-byte aligned.
extern "C" int adapm_alltoall_put(const void* src,
                                  const unsigned long long* dst, int P,
                                  long long row_bytes, long long dst_off,
                                  cudaStream_t stream) {
  if (P <= 0 || row_bytes < 0 || row_bytes % 16 || dst_off % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_bytes == 0) return 0;
  const long long row_vec = row_bytes / 16;
  long long bx = (row_vec + kThreads - 1) / kThreads;
  const long long cap = kMaxBlocks / P > 0 ? kMaxBlocks / P : 1;
  if (bx > cap) bx = cap;
  put_kernel<<<dim3(static_cast<unsigned>(bx), P), kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(src), dst, row_vec, dst_off / 16);
  return static_cast<int>(cudaGetLastError());
}

// A zeroed receive slab of `bytes` from cudaMalloc, and its 64-byte IPC
// handle written to `handle`.
extern "C" int adapm_a2a_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, *ptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::memcpy(handle, &h, sizeof(h));
  return 0;
}

// Map a peer's slab from its 64-byte handle.
extern "C" int adapm_a2a_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

// Unmap a peer's slab (before the peer frees it).
extern "C" int adapm_a2a_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Free this process's own slab (after every peer unmapped it).
extern "C" int adapm_a2a_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

extern "C" int adapm_a2a_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}
