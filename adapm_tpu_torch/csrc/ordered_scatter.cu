// K3 ordered_scatter_add: the drop-mode scatter-add with duplicates
// folded into the stored row one at a time, in batch order.
//
// Replaces the XLA scatter the JAX package runs for every Push, every
// fused-step update and the compressed sync round's merge
// (adapm_tpu/device/jaxport.py _scatter_add and
// _sync_replicas_compressed, ops/fused.py _scatter_update and the
// no-replica add; the plain and thresholded rounds fold through K15,
// csrc/sync_round.cu, which shares this fold); the TPU side has no
// Pallas kernel for it, its row gather twin is pallas_kernels.gather_rows.
// Its contract is np.add.at (device/refport.py _drop_add):
//
//   for i in batch order, if (sh[i], sl[i]) is in range:
//       pool[sh[i], sl[i]] = pool[sh[i], sl[i]] + vals[i]     (f32, rounded)
//
// which an atomic add (index_add_ on CUDA) cannot keep: its order, and
// so its rounding, changes from run to run.
//
// A call takes an ordered list of coordinate segments (the roles of one
// pool class) and one [sum n, L] value buffer; the batch order of the
// concatenation is segment order, then position, so one call equals one
// call per segment in list order, bit for bit.
//
// Bound on an H100: bytes. Each value row is read once, each distinct
// stored row is read and written once, plus the indices (int32
// coordinates in, int32 sorted targets and int64 permutation).
//
// Design, in two kernels around a stable sort:
//  1. flat_targets: one pass over the segments' coordinates writes the
//     int32 flat target row of every entry (S*R, past the last row, for
//     an out-of-range one). The wrapper stable-sorts these (torch.sort),
//     so each target's occurrences form one run in batch order and the
//     dropped entries sort last.
//  2. ordered_fold: the fold of csrc/ordered_fold.cuh (shared with
//     K15), over the [n, L] value buffer: a persistent grid of warps,
//     each folding whole runs of equal targets in run order, the value
//     rows streamed through a per-warp cp.async ring in shared memory.
#include <cuda_runtime.h>

#include "ordered_fold.cuh"

namespace {

constexpr int kMaxSeg = 8;   // segments per call (the wrapper packs more)

struct Segments {
  const int* sh[kMaxSeg];
  const int* sl[kMaxSeg];
  long long end[kMaxSeg];    // cumulative ends
  int count;
};

__global__ void flat_targets_kernel(Segments segs, int* __restrict__ flat,
                                    long long n, int shards, int slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int s = 0;
    long long start = 0;
    while (s + 1 < segs.count && i >= segs.end[s]) start = segs.end[s++];
    const int sh = segs.sh[s][i - start];
    const int sl = segs.sl[s][i - start];
    const bool ok = sh >= 0 && sh < shards && sl >= 0 && sl < slots;
    flat[i] = ok ? (int)((long long)sh * slots + sl) : shards * slots;
  }
}

}  // namespace

// The ordering pass's first step: flat[i] = the int32 target row of
// entry i of the concatenated segments, or shards*slots when out of range
// (shards*slots < 2^31 - 1, checked by the wrapper).
extern "C" int adapm_flat_targets(const int* const* sh, const int* const* sl,
                                  const long long* sizes, int nseg,
                                  int* flat, int shards, int slots,
                                  cudaStream_t stream) {
  if (nseg < 1 || nseg > kMaxSeg) return (int)cudaErrorInvalidValue;
  Segments segs{};
  long long n = 0;
  for (int s = 0; s < nseg; ++s) {
    segs.sh[s] = sh[s];
    segs.sl[s] = sl[s];
    n += sizes[s];
    segs.end[s] = n;
  }
  segs.count = nseg;
  if (n <= 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  flat_targets_kernel<<<(unsigned)blocks, 256, 0, stream>>>(segs, flat, n,
                                                            shards, slots);
  return (int)cudaGetLastError();
}

// sf/perm: [n], sf the int32 flat targets sorted ascending (stable),
// perm[j] the batch position of sorted entry j; vals: [n, L]; pool: `rows`
// rows of L. vec: L % 4 == 0 and pool/vals 16-byte aligned.
extern "C" int adapm_ordered_fold(float* pool, const int* sf,
                                  const long long* perm, const float* vals,
                                  long long n, int rows, int L, int vec,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  using adapm::fold::DenseRows;
  using adapm::fold::launch_fold;
  if (vec)
    return launch_fold(reinterpret_cast<float4*>(pool), sf, perm,
                       DenseRows<float4>{reinterpret_cast<const float4*>(
                           vals)},
                       n, rows, L / 4, stream);
  return launch_fold(pool, sf, perm, DenseRows<float>{vals}, n, rows, L,
                     stream);
}
