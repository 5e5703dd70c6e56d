// K3 ordered_scatter_add: the drop-mode scatter-add with duplicates
// folded into the stored row one at a time, in batch order.
//
// Replaces the XLA scatter the JAX package runs for every Push, every
// fused-step update and the sync merge (device/jaxport.py _scatter_add
// and _sync_replicas, ops/fused.py _scatter_update and the no-replica
// add). Its contract is np.add.at (device/refport.py _drop_add):
//
//   for i in batch order, if (sh[i], sl[i]) is in range:
//       pool[sh[i], sl[i]] = pool[sh[i], sl[i]] + vals[i]     (f32, rounded)
//
// which an atomic add (index_add_ on CUDA) cannot keep: its order, and
// so its rounding, changes from run to run.
//
// Design: the wrapper stable-sorts the batch by flat target row (out of
// range entries get the sentinel `rows`, which sorts last), so each
// target's occurrences form one run in batch order. One block per
// sorted entry; only the head of a run works: each thread owns four
// columns and folds the run's value rows into the stored row with
// __fadd_rn, in run order, then writes it back once. Distinct runs
// touch distinct rows, so blocks never race.
//
// Bound on an H100: bytes (the run's value rows are read once, the
// stored row is read and written once).
#include <cuda_runtime.h>

namespace {

template <bool kVec>
__global__ void ordered_scatter_kernel(float* __restrict__ pool,
                                       const long long* __restrict__ flat,
                                       const long long* __restrict__ perm,
                                       const float* __restrict__ vals,
                                       long long n, long long rows, int L) {
  const long long i = blockIdx.x;
  const long long t = flat[i];
  if (t >= rows) return;                      // dropped (out of range)
  if (i > 0 && flat[i - 1] == t) return;      // not the head of its run
  long long end = i + 1;
  while (end < n && flat[end] == t) ++end;
  float* dst = pool + t * (long long)L;
  if (kVec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = threadIdx.x; c < (L >> 2); c += blockDim.x) {
      float4 a = d4[c];
      for (long long j = i; j < end; ++j) {
        const float4 v = __ldg(
            reinterpret_cast<const float4*>(vals + perm[j] * (long long)L) + c);
        a.x = __fadd_rn(a.x, v.x);
        a.y = __fadd_rn(a.y, v.y);
        a.z = __fadd_rn(a.z, v.z);
        a.w = __fadd_rn(a.w, v.w);
      }
      d4[c] = a;
    }
  } else {
    for (int c = threadIdx.x; c < L; c += blockDim.x) {
      float a = dst[c];
      for (long long j = i; j < end; ++j)
        a = __fadd_rn(a, __ldg(vals + perm[j] * (long long)L + c));
      dst[c] = a;
    }
  }
}

}  // namespace

// flat/perm: [n] int64, flat sorted ascending (stable), perm[j] = the
// batch position of sorted entry j; vals: [n, L]; pool: `rows` rows of L.
extern "C" int adapm_ordered_scatter_add(float* pool, const long long* flat,
                                         const long long* perm,
                                         const float* vals, long long n,
                                         long long rows, int L, int vec,
                                         cudaStream_t stream) {
  if (n <= 0) return 0;
  int threads = vec ? (L / 4) : L;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  if (vec)
    ordered_scatter_kernel<true><<<(unsigned)n, threads, 0, stream>>>(
        pool, flat, perm, vals, n, rows, L);
  else
    ordered_scatter_kernel<false><<<(unsigned)n, threads, 0, stream>>>(
        pool, flat, perm, vals, n, rows, L);
  return (int)cudaGetLastError();
}
