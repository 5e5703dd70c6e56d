// K15 sync_round: one planner round over a batch of replicas, the merge
// half.
//
// Replaces the XLA programs adapm_tpu/device/jaxport.py _sync_replicas
// (:126) and _sync_replicas_thresholded (:188): for replica i at
// (r_sh[i], r_cs[i]) of the [S, C, L] cache/delta pair, owned at
// (o_sh[i], o_sl[i]) of the [S, R, L] main pool,
//
//   d[i]    = fill(delta)[r_sh[i], r_cs[i]]
//   ship[i] = threshold > 0 ? max|d[i]| >= threshold : true
//             (a held row's two coordinates become OOB: no merge, no
//             refresh, its delta stays)
//   main.at[o_sh, o_sl'].add(d, mode="drop")      in batch order (K3's)
//   cache.at[r_sh, r_cs'].set(fill(main)[o_sh, o_sl'], mode="drop")
//   delta.at[r_sh, r_cs'].set(0, mode="drop")
//
// bit for bit, with the fold's order (main + d1) + d2, never
// main + (d1 + d2), where several replicas share an owner.
//
// Bound on an H100: bytes. Each shipped delta row is read once and each
// distinct owner row read and written once; each winning replica's cache
// and delta rows are written once (the fresh owner row read again);
// plus the coordinates, the int32 targets and the int64 permutation.
//
// The port used to run the round as K1 (extract the deltas into an
// [n, L] buffer), the threshold in torch ops, K3 (its ordering pass and
// fold), K1 again (the fresh owner rows into a second [n, L] buffer) and
// two sets. Here neither buffer exists:
//   1. ship pass (this file): the int32 flat owner target of every entry
//      (S*R for a dropped or held one) and the masked replica and owner
//      slots; with a threshold, one warp an entry takes its delta row's
//      max-abs (NaN propagates, as jnp.max and torch.amax do, and then
//      fails the test);
//   2. the wrapper's stable torch.sort of the targets (K3's ordering);
//   3. fold (this file): K3's fold (ordered_fold.cuh) reading each value
//      row straight from `delta` at the replica's coordinates, a zero
//      row where they are out of range;
//   4. K14's install form (drop_set.cu), called by the wrapper: one
//      claim over the shipped replicas, each winner writing the fresh
//      owner row, read straight from `main`, as its base and zeros as
//      its delta.
#include <cuda_runtime.h>

#include "ordered_fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kShipWarps = 8;

__device__ __forceinline__ bool in_range(int s, int r, int S, int R) {
  return s >= 0 && s < S && r >= 0 && r < R;
}

__device__ __forceinline__ float absmax(float m, float x) {
  const float a = fabsf(x);
  return (a > m || a != a) ? a : m;   // NaN sticks: no a > NaN holds
}
__device__ __forceinline__ float absmax(float m, float4 x) {
  return absmax(absmax(absmax(absmax(m, x.x), x.y), x.z), x.w);
}

__device__ __forceinline__ void emit(long long i, bool ship, int rc, int os,
                                     int ol, int So, int Ro, int oob,
                                     int* flat, int* rcs_out, int* osl_out) {
  flat[i] = ship && in_range(os, ol, So, Ro) ? (int)((long long)os * Ro + ol)
                                             : So * Ro;
  rcs_out[i] = ship ? rc : oob;
  osl_out[i] = ship ? ol : oob;
}

// no threshold: every entry ships, one thread an entry
__global__ void __launch_bounds__(kThreads) targets_kernel(
    const int* __restrict__ r_cs, const int* __restrict__ o_sh,
    const int* __restrict__ o_sl, long long n, int So, int Ro, int oob,
    int* __restrict__ flat, int* __restrict__ rcs_out,
    int* __restrict__ osl_out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    emit(i, true, __ldg(r_cs + i), __ldg(o_sh + i), __ldg(o_sl + i), So, Ro,
         oob, flat, rcs_out, osl_out);
}

// with a threshold: one warp an entry reads its delta row's max-abs
template <typename T>
__global__ void __launch_bounds__(kShipWarps * 32) ship_kernel(
    const T* __restrict__ delta, const int* __restrict__ r_sh,
    const int* __restrict__ r_cs, const int* __restrict__ o_sh,
    const int* __restrict__ o_sl, long long n, int S, int C, int W, int So,
    int Ro, float threshold, int oob, int* __restrict__ flat,
    int* __restrict__ rcs_out, int* __restrict__ osl_out) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kShipWarps;
  for (long long i = (long long)blockIdx.x * kShipWarps + (threadIdx.x >> 5);
       i < n; i += nwarps) {
    const int rs = __ldg(r_sh + i), rc = __ldg(r_cs + i);
    float m = 0.f;
    if (in_range(rs, rc, S, C)) {
      const T* row = delta + ((long long)rs * C + rc) * W;
      for (int c = lane; c < W; c += 32) m = absmax(m, __ldg(row + c));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = absmax(m, __shfl_xor_sync(~0u, m, o));
    if (lane == 0)
      emit(i, m >= threshold, rc, __ldg(o_sh + i), __ldg(o_sl + i), So, Ro,
           oob, flat, rcs_out, osl_out);
  }
}

}  // namespace

// The ship pass. delta: [S, C, L] f32; n replicas at (r_sh, r_cs) owned
// at (o_sh, o_sl) of an [So, Ro, L] main pool (So * Ro < 2^31 - 1). Writes
// flat[i] (the int32 owner row, So * Ro when dropped or held), rcs_out[i]
// and osl_out[i] (r_cs[i] and o_sl[i], `oob` when held). thresholded:
// hold rows whose delta max-abs is below `threshold`. vec: L % 4 == 0
// and delta 16-byte aligned.
extern "C" int adapm_sync_ship(const float* delta, const int* r_sh,
                               const int* r_cs, const int* o_sh,
                               const int* o_sl, long long n, int S, int C,
                               int L, int So, int Ro, int thresholded,
                               float threshold, int oob, int* flat,
                               int* rcs_out, int* osl_out, int vec,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!thresholded) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    targets_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        r_cs, o_sh, o_sl, n, So, Ro, oob, flat, rcs_out, osl_out);
    return (int)cudaGetLastError();
  }
  long long blocks = (n + kShipWarps - 1) / kShipWarps;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (vec)
    ship_kernel<float4><<<(unsigned)blocks, kShipWarps * 32, 0, stream>>>(
        reinterpret_cast<const float4*>(delta), r_sh, r_cs, o_sh, o_sl, n, S,
        C, L / 4, So, Ro, threshold, oob, flat, rcs_out, osl_out);
  else
    ship_kernel<float><<<(unsigned)blocks, kShipWarps * 32, 0, stream>>>(
        delta, r_sh, r_cs, o_sh, o_sl, n, S, C, L, So, Ro, threshold, oob,
        flat, rcs_out, osl_out);
  return (int)cudaGetLastError();
}

// The fold. main: [So, Ro, L] f32 (`rows` = So * Ro); sf/perm: the ship
// pass's targets sorted ascending (stable) and the permutation; entry
// perm[j]'s value row is fill(delta)[r_sh[perm[j]], rcs[perm[j]]] of the
// [S, C, L] delta pool. vec: L % 4 == 0, main and delta 16-byte aligned.
extern "C" int adapm_sync_fold(float* main, const int* sf,
                               const long long* perm, const float* delta,
                               const int* r_sh, const int* rcs, long long n,
                               int rows, int S, int C, int L, int vec,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  using adapm::fold::PoolRows;
  using adapm::fold::launch_fold;
  if (vec)
    return launch_fold(reinterpret_cast<float4*>(main), sf, perm,
                       PoolRows<float4>{
                           reinterpret_cast<const float4*>(delta), r_sh, rcs,
                           S, C},
                       n, rows, L / 4, stream);
  return launch_fold(main, sf, perm, PoolRows<float>{delta, r_sh, rcs, S, C},
                     n, rows, L, stream);
}
