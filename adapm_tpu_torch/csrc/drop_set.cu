// K14 drop_set: the masked set/copy programs of the device port, as one
// claim/write resolver in three forms.
//
// Replaces the XLA programs of adapm_tpu/device/jaxport.py that set rows
// in drop mode: _set_rows (:104), _replica_create (:114), _install_rows
// (:214), _refresh_after_sync's base (:224), _relocate's write (:237),
// _clear_rows (:283), _install_cache_rows{,_resid} (:290, :300) and the
// sets of the sync rounds (:126, :140, :188; K15 and the compressed
// round). Each computes pool.at[sh, sl].set(vals, mode="drop") with
// refport._drop_set's contract:
//
//   - an entry whose sh is outside [0, S) or whose sl is outside [0, R)
//     (negative included, and the OOB padding 2^31-2) drops;
//   - of several entries naming one row, the last in batch order wins;
//   - bits are copied, never computed, so -0.0 (and any NaN payload)
//     survives.
//
// Bound on an H100: bytes (each winner's source row read once, its
// destination rows written once; the coordinates). The port used to
// resolve the winners with torch ops before an indexed write (flat
// targets, a stable sort, a mask: some ten small launches a set). Here,
// as in K11 (write_main_rows.cu), the card resolves them itself:
//
// - claim: one thread an entry; an in-range entry e takes
//   atomicMax(&claim[t], e) on an int32 scratch of one word per pool row
//   (t = sh * R + sl), so claim[t] ends as the last entry naming t;
// - write: one warp an entry; lane 0 reads claim[t], and only the entry
//   that finds itself there writes (16-byte streaming stores of float4
//   where L % 4 == 0) and then sets claim[t] back to -1. A losing entry
//   reads the winner's index or -1, never its own, so the reset cannot
//   make it write. After every call the scratch is all -1 again.
//
// The forms, one C entry each:
//   1. adapm_drop_set: one pool, the winners' f32 source rows [m, L]
//      (set_rows' main half, refresh's base, relocate's write).
//   2. adapm_drop_set_install: one claim over the replica coordinates of
//      a cache/delta pair (same [S, R, L]); each winner writes its source
//      row into cache and zeros, or its row of a second source (`resid`),
//      into delta. The source is a [m, L] buffer or, with `src_pool`
//      given, the fill-read fill(src_pool)[o_sh[e], o_sl[e]] of another
//      pool (a zero row out of range), read where it lies: the fresh
//      owner row of a sync round or a replica's first base, with no
//      gather buffer between. (set_rows' cache half, replica_create,
//      install_rows, install_cache_rows{,_resid}, the sync rounds' sets.)
//   3. adapm_drop_set_zero: zero rows, no source and no claim: every
//      in-range entry writes the same zero bits, so which one lands last
//      cannot matter (clear_rows, relocate's delta clear).
//
// A call's two launches (claim, write) are enqueued under one lock, so no
// other call's launch on that stream falls between them; calls on one
// stream run in order. No form reallocates a pool: a captured CUDA graph
// holds its address (ops/fused.py DeviceRoutedRunner.run_scan).
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kClaimThreads = 256;
constexpr int kWarps = 8;   // warps per CTA of the write, an entry each

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ bool in_range(int s, int r, int S, int R) {
  return s >= 0 && s < S && r >= 0 && r < R;
}

__global__ void __launch_bounds__(kClaimThreads) claim_kernel(
    int* __restrict__ claim, const int* __restrict__ sh,
    const int* __restrict__ sl, int m, int S, int R) {
  const int e = blockIdx.x * kClaimThreads + threadIdx.x;
  if (e >= m) return;
  const int s = __ldg(sh + e), r = __ldg(sl + e);
  if (in_range(s, r, S, R)) atomicMax(claim + (long long)s * R + r, e);
}

// The winners' write. dst (and dst2 when kPair) are [S, R, W] pools of
// T; the source row of entry e is rows[e] or, when kGather, the fill-read
// of src_pool ([So, Ro, W]) at (o_sh[e], o_sl[e]); dst2's row is
// resid[e], or zeros when resid is null.
template <typename T, bool kPair, bool kGather>
__global__ void __launch_bounds__(kWarps * 32) write_kernel(
    T* __restrict__ dst, T* __restrict__ dst2, int* __restrict__ claim,
    const int* __restrict__ sh, const int* __restrict__ sl,
    const T* __restrict__ rows, const T* __restrict__ src_pool,
    const int* __restrict__ o_sh, const int* __restrict__ o_sl, int So,
    int Ro, const T* __restrict__ resid, int m, int S, int R, int W) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= m) return;                       // the whole warp
  const int s = __ldg(sh + e), r = __ldg(sl + e);
  if (!in_range(s, r, S, R)) return;
  const long long t = (long long)s * R + r;
  // claim is written in this launch (the resets): a plain load, which
  // sees the winner's index or -1
  int won = 0;
  if (lane == 0) won = claim[t] == e;
  if (!__shfl_sync(~0u, won, 0)) return;
  const T* src;
  if (kGather) {
    const int os = __ldg(o_sh + e), ol = __ldg(o_sl + e);
    src = in_range(os, ol, So, Ro) ? src_pool + ((long long)os * Ro + ol) * W
                                   : nullptr;
  } else {
    src = rows + (long long)e * W;
  }
  T* d1 = dst + t * W;
  T* d2 = kPair ? dst2 + t * W : nullptr;
  const T* rs = kPair && resid != nullptr ? resid + (long long)e * W
                                          : nullptr;
#pragma unroll 4
  for (int c = lane; c < W; c += 32) {
    __stcs(d1 + c, src != nullptr ? __ldg(src + c) : zero<T>());
    if (kPair) __stcs(d2 + c, rs != nullptr ? __ldg(rs + c) : zero<T>());
  }
  if (lane == 0) claim[t] = -1;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) zero_kernel(
    T* __restrict__ dst, const int* __restrict__ sh,
    const int* __restrict__ sl, int m, int S, int R, int W) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= m) return;
  const int s = __ldg(sh + e), r = __ldg(sl + e);
  if (!in_range(s, r, S, R)) return;
  T* d = dst + ((long long)s * R + r) * W;
#pragma unroll 4
  for (int c = lane; c < W; c += 32) __stcs(d + c, zero<T>());
}

std::mutex& launch_mutex() {   // a call's two launches stay adjacent
  static std::mutex mu;
  return mu;
}

template <typename T, bool kPair, bool kGather>
int launch(T* dst, T* dst2, int* claim, const int* sh, const int* sl,
           const T* rows, const T* src_pool, const int* o_sh,
           const int* o_sl, int So, int Ro, const T* resid, int m, int S,
           int R, int W, cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(launch_mutex());
  claim_kernel<<<(m + kClaimThreads - 1) / kClaimThreads, kClaimThreads, 0,
                 stream>>>(claim, sh, sl, m, S, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  write_kernel<T, kPair, kGather>
      <<<(m + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          dst, dst2, claim, sh, sl, rows, src_pool, o_sh, o_sl, So, Ro,
          resid, m, S, R, W);
  return (int)cudaGetLastError();
}

template <typename T>
const T* as(const float* p) {
  return reinterpret_cast<const T*>(p);
}
template <typename T>
T* as(float* p) {
  return reinterpret_cast<T*>(p);
}

}  // namespace

// Form 1. pool: [S, R, L] f32; m entries with int32 coordinates (sh, sl),
// entry e writing row e of rows ([m, L] f32). claim: the int32 scratch of
// S * R words, all -1 before the call and after it. vec: L % 4 == 0, pool
// and rows 16-byte aligned.
extern "C" int adapm_drop_set(float* pool, int* claim, const int* sh,
                              const int* sl, const float* rows, int m,
                              int S, int R, int L, int vec,
                              cudaStream_t stream) {
  if (m <= 0) return 0;
  if (claim == nullptr || rows == nullptr) return (int)cudaErrorInvalidValue;
  if (vec)
    return launch<float4, false, false>(
        as<float4>(pool), nullptr, claim, sh, sl, as<float4>(rows), nullptr,
        nullptr, nullptr, 0, 0, nullptr, m, S, R, L / 4, stream);
  return launch<float, false, false>(pool, nullptr, claim, sh, sl, rows,
                                     nullptr, nullptr, nullptr, 0, 0,
                                     nullptr, m, S, R, L, stream);
}

// Form 2. cache, delta: [S, R, L] f32; one claim over (c_sh, c_sl). The
// winner e writes into cache its row of `rows` ([m, L] f32) or, when rows
// is null, fill(src_pool)[o_sh[e], o_sl[e]] (src_pool [So, Ro, L] f32,
// int32 coordinates), and into delta its row of resid ([m, L] f32) or
// zeros when resid is null. vec: L % 4 == 0, every pool and buffer
// 16-byte aligned.
extern "C" int adapm_drop_set_install(
    float* cache, float* delta, int* claim, const int* c_sh,
    const int* c_sl, const float* rows, const float* src_pool,
    const int* o_sh, const int* o_sl, int So, int Ro, const float* resid,
    int m, int S, int R, int L, int vec, cudaStream_t stream) {
  if (m <= 0) return 0;
  if (claim == nullptr ||
      (rows == nullptr &&
       (src_pool == nullptr || o_sh == nullptr || o_sl == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (rows != nullptr) {
    if (vec)
      return launch<float4, true, false>(
          as<float4>(cache), as<float4>(delta), claim, c_sh, c_sl,
          as<float4>(rows), nullptr, nullptr, nullptr, 0, 0,
          as<float4>(resid), m, S, R, L / 4, stream);
    return launch<float, true, false>(cache, delta, claim, c_sh, c_sl, rows,
                                      nullptr, nullptr, nullptr, 0, 0, resid,
                                      m, S, R, L, stream);
  }
  if (vec)
    return launch<float4, true, true>(
        as<float4>(cache), as<float4>(delta), claim, c_sh, c_sl, nullptr,
        as<float4>(src_pool), o_sh, o_sl, So, Ro, as<float4>(resid), m, S, R,
        L / 4, stream);
  return launch<float, true, true>(cache, delta, claim, c_sh, c_sl, nullptr,
                                   src_pool, o_sh, o_sl, So, Ro, resid, m, S,
                                   R, L, stream);
}

// Form 3. pool: [S, R, L] f32; every in-range (sh, sl) row set to zeros.
// vec: L % 4 == 0 and pool 16-byte aligned.
extern "C" int adapm_drop_set_zero(float* pool, const int* sh, const int* sl,
                                   int m, int S, int R, int L, int vec,
                                   cudaStream_t stream) {
  if (m <= 0) return 0;
  if (vec)
    zero_kernel<float4><<<(m + kWarps - 1) / kWarps, kWarps * 32, 0,
                          stream>>>(as<float4>(pool), sh, sl, m, S, R,
                                    L / 4);
  else
    zero_kernel<float><<<(m + kWarps - 1) / kWarps, kWarps * 32, 0,
                         stream>>>(pool, sh, sl, m, S, R, L);
  return (int)cudaGetLastError();
}
