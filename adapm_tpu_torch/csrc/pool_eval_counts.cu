// K4 pool_eval_counts: the all-entity rank count of the filtered-MRR eval.
//
// Replaces the XLA program of adapm_tpu/models/kge.py
// make_pool_eval_counts (a lax.scan over [B, C] candidate tiles gathered
// from the main pool). For every query b and every candidate c of the
// padded candidate-key table:
//
//   row_c  = pool[owner[key_c], slot[key_c], :K]
//   g_o[b] += (Q_o[b] . row_c > true_sc[b]) & (c < nvalid) & (key_c != okey[b])
//   g_s[b] += (Q_s[b] . row_c > true_sc[b]) & (c < nvalid) & (key_c != skey[b])
//
// Q_o/Q_s [B, K] are the query coefficients of the model (ComplEx:
// [a | b] and [c | d] of complex_eval_scores, K = 2d; RESCAL: sR and Ro,
// K = d), so the dot equals the JAX program's `a@er.T + b@ei.T` (or
// `sR@ent.T`) in exact arithmetic. The pool row stride is L >= K; only
// the first K columns are read. The true key is excluded by KEY, not by
// score. A coordinate outside the pool reads a zero row (fill, as K1).
//
// Bound on an H100: operations. Each candidate row (K f32) is read once
// and meets all B queries on both sides: 2*B*K FMAs per 4*K bytes, which
// at B=64 is 32 FMAs per byte, far above the f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte).
//
// Design (simple and exact first): one 256-thread CTA takes a tile of 64
// candidates times 64 queries. Candidate rows and both query tiles are
// staged in shared memory K-major, 32 columns at a time (16-byte global
// loads, the next chunk's in flight while this one is computed, where
// the row length allows them), so each thread reads its 4 candidates and
// 4+4 queries with three 16-byte shared loads per column and keeps a 4x4
// tile of dots per side in registers. Dots are
// f32 FMA chains in sequential k order (no TF32, no tensor cores: TF32
// would flip counts at near-ties of the f32 reference). Each thread then
// compares its 32 dots, a half-warp shuffle reduction sums the counts of
// one query over the tile's 64 candidates, and one lane per query adds
// them with an integer atomicAdd, which makes the result independent of
// the order in which the CTAs run.
#include <cuda_runtime.h>

namespace {

constexpr int kTC = 64;        // candidates per CTA
constexpr int kTQ = 64;        // queries per CTA
constexpr int kKC = 32;        // columns staged per pass
constexpr int kPad = 4;        // row padding of the K-major tiles (floats)
constexpr int kThreads = 256;

// Stage one 32-column chunk of the candidate rows and both query tiles
// into the K-major shared tiles. Vector form: 16-byte loads, so a warp
// reads 4 rows x 128 contiguous bytes (rows need L % 4 == 0, K % 4 == 0
// and 16-byte aligned pointers); the loads for chunk k0 + 32 are issued
// before the compute of chunk k0 (register double buffering).
struct Stage4 {
  float4 r[2], o[2], s[2];
};

__device__ __forceinline__ void load4(Stage4& st, const float* const* ptr,
                                      const float* __restrict__ q_o,
                                      const float* __restrict__ q_s, int K,
                                      int k0, int q0, int B, int tid) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = tid + kThreads * m;  // 512 float4 per tile
    const int r = e >> 3, c = k0 + 4 * (e & 7);
    const float* p = ptr[r];
    st.r[m] = (p != nullptr && c < K)
                  ? __ldg(reinterpret_cast<const float4*>(p + c)) : z;
    const int qb = q0 + r;
    const bool ok = qb < B && c < K;
    const long long off = (long long)qb * K + c;
    st.o[m] = ok ? __ldg(reinterpret_cast<const float4*>(q_o + off)) : z;
    st.s[m] = ok ? __ldg(reinterpret_cast<const float4*>(q_s + off)) : z;
  }
}

__device__ __forceinline__ void store4(const Stage4& st,
                                       float (*s_row)[kTC + kPad],
                                       float (*s_qo)[kTQ + kPad],
                                       float (*s_qs)[kTQ + kPad], int tid) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = tid + kThreads * m;
    const int r = e >> 3, c = 4 * (e & 7);
    const float4 v = st.r[m], a = st.o[m], b = st.s[m];
    s_row[c][r] = v.x; s_row[c + 1][r] = v.y;
    s_row[c + 2][r] = v.z; s_row[c + 3][r] = v.w;
    s_qo[c][r] = a.x; s_qo[c + 1][r] = a.y;
    s_qo[c + 2][r] = a.z; s_qo[c + 3][r] = a.w;
    s_qs[c][r] = b.x; s_qs[c + 1][r] = b.y;
    s_qs[c + 2][r] = b.z; s_qs[c + 3][r] = b.w;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) pool_eval_counts_kernel(
    const float* __restrict__ pool, int shards, int slots, int L, int K,
    const int* __restrict__ owner, const int* __restrict__ slot,
    long long num_keys, const int* __restrict__ keys, long long nvalid,
    const float* __restrict__ q_o, const float* __restrict__ q_s,
    const float* __restrict__ true_sc, const int* __restrict__ okey,
    const int* __restrict__ skey, int B, int* __restrict__ g_o,
    int* __restrict__ g_s) {
  __shared__ __align__(16) float s_row[kKC][kTC + kPad];
  __shared__ __align__(16) float s_qo[kKC][kTQ + kPad];
  __shared__ __align__(16) float s_qs[kKC][kTQ + kPad];
  __shared__ const float* s_ptr[kTC];
  __shared__ int s_key[kTC];

  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * kTC;
  const int q0 = blockIdx.y * kTQ;
  if (tid < kTC) {
    const long long c = c0 + tid;
    const float* p = nullptr;
    int key = -1;
    if (c < nvalid) {
      key = keys[c];
      if (key >= 0 && key < num_keys) {
        const int sh = owner[key], sl = slot[key];
        if (sh >= 0 && sh < shards && sl >= 0 && sl < slots)
          p = pool + ((long long)sh * slots + sl) * (long long)L;
      }
    }
    s_ptr[tid] = p;
    s_key[tid] = key;
  }
  __syncthreads();

  const int tx = tid & 15;  // candidates 4*tx .. 4*tx+3
  const int ty = tid >> 4;  // queries 4*ty .. 4*ty+3
  float acc_o[4][4], acc_s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_o[j][i] = acc_s[j][i] = 0.f;

  Stage4 st;
  if (kVec) load4(st, s_ptr, q_o, q_s, K, 0, q0, B, tid);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    if (kVec) {
      store4(st, s_row, s_qo, s_qs, tid);
    } else {
      // scalar staging: a warp reads 32 consecutive columns of one row
      for (int i = tid; i < kTC * kKC; i += kThreads) {
        const int r = i / kKC, kk = i % kKC;
        const float* p = s_ptr[r];
        s_row[kk][r] = (p != nullptr && k0 + kk < K) ? __ldg(p + k0 + kk)
                                                     : 0.f;
      }
      for (int i = tid; i < kTQ * kKC; i += kThreads) {
        const int b = i / kKC, kk = i % kKC;
        const int qb = q0 + b;
        const bool ok = qb < B && k0 + kk < K;
        const long long off = (long long)qb * K + k0 + kk;
        s_qo[kk][b] = ok ? __ldg(q_o + off) : 0.f;
        s_qs[kk][b] = ok ? __ldg(q_s + off) : 0.f;
      }
    }
    __syncthreads();
    if (kVec && k0 + kKC < K)
      load4(st, s_ptr, q_o, q_s, K, k0 + kKC, q0, B, tid);
    // columns past K are zero on both sides: fma(0, 0, acc) == acc, so
    // the sum is the sequential-k FMA chain over the K real columns
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 r = *reinterpret_cast<const float4*>(&s_row[kk][4 * tx]);
      const float4 a = *reinterpret_cast<const float4*>(&s_qo[kk][4 * ty]);
      const float4 s = *reinterpret_cast<const float4*>(&s_qs[kk][4 * ty]);
      const float rv[4] = {r.x, r.y, r.z, r.w};
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_o[j][i] = __fmaf_rn(av[j], rv[i], acc_o[j][i]);
          acc_s[j][i] = __fmaf_rn(sv[j], rv[i], acc_s[j][i]);
        }
    }
    __syncthreads();
  }

  int cnt_o[4], cnt_s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qb = q0 + 4 * ty + j;
    cnt_o[j] = cnt_s[j] = 0;
    if (qb >= B) continue;
    const float t = true_sc[qb];
    const int ok = okey[qb], sk = skey[qb];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * tx + i;
      if (c0 + c >= nvalid) continue;
      const int key = s_key[c];
      cnt_o[j] += (acc_o[j][i] > t) & (key != ok);
      cnt_s[j] += (acc_s[j][i] > t) & (key != sk);
    }
  }
  // sum over the 16 candidate lanes of a half-warp (lanes sharing ty)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cnt_o[j] += __shfl_xor_sync(0xffffffffu, cnt_o[j], off);
      cnt_s[j] += __shfl_xor_sync(0xffffffffu, cnt_s[j], off);
    }
  if (tx == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qb = q0 + 4 * ty + j;
      if (qb >= B) continue;
      if (cnt_o[j]) atomicAdd(g_o + qb, cnt_o[j]);
      if (cnt_s[j]) atomicAdd(g_s + qb, cnt_s[j]);
    }
  }
}

}  // namespace

// g_o/g_s must be zeroed by the caller; the kernel adds into them.
extern "C" int adapm_pool_eval_counts(
    const float* pool, int shards, int slots, int L, int K, const int* owner,
    const int* slot, long long num_keys, const int* keys, long long nvalid,
    const float* q_o, const float* q_s, const float* true_sc,
    const int* okey, const int* skey, int B, int vec, int* g_o, int* g_s,
    cudaStream_t stream) {
  if (nvalid <= 0 || B <= 0) return 0;
  const dim3 grid((unsigned)((nvalid + kTC - 1) / kTC),
                  (unsigned)((B + kTQ - 1) / kTQ));
  if (vec)
    pool_eval_counts_kernel<true><<<grid, kThreads, 0, stream>>>(
        pool, shards, slots, L, K, owner, slot, num_keys, keys, nvalid, q_o,
        q_s, true_sc, okey, skey, B, g_o, g_s);
  else
    pool_eval_counts_kernel<false><<<grid, kThreads, 0, stream>>>(
        pool, shards, slots, L, K, owner, slot, num_keys, keys, nvalid, q_o,
        q_s, true_sc, okey, skey, B, g_o, g_s);
  return (int)cudaGetLastError();
}
