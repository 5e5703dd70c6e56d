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
// Bound on an H100: f32 operations. Each candidate row (K f32) is read
// once and meets all B queries on both sides: 2*B*K FMAs per 4*K bytes,
// at B=64 32 FMAs per byte, far above the f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte). Dots stay f32 FMA chains in k order on
// the CUDA cores: TF32 would flip counts at near-ties of the f32
// reference.
//
// Design. One CTA of 256 threads per SM (a persistent grid: the launch
// plan, ops/kernels.py _k4_plan, sizes it from the SM count) walks the
// candidate tiles of 128 rows with stride gridDim.x, for one block of
// Bq = 16*TQ queries (blockIdx.y). The kernel it replaces (64 x 64 tiles,
// 3,125 short CTAs at 200,000 candidates) restaged both query tiles in
// every CTA, staged through registers with transposing 4-byte stores
// (4-way bank conflicts, two barriers per 32 columns) and held a 4 x 4
// tile per thread. What each part does now:
//  - Resident queries. The CTA copies its query block of both sides into
//    shared memory once, as [K/4][Bq][4] (four consecutive k of a query
//    in one 16-byte word), and reads it for every tile. Where the block
//    does not fit beside the ring (large K even at Bq=16), the plan
//    streams each chunk of the queries through the ring with its
//    candidate chunk instead (`resident` = 0).
//  - A cp.async ring. Candidate rows go from the pool to shared memory
//    as 128-row x 64-column chunks, row-major with a pitch of 68 floats
//    (16-byte cp.async.cg, or 4-byte cp.async.ca where rows or pointers
//    are not 16-byte aligned: the template parameter kVec), the next
//    chunk in flight while this one is computed; one barrier per chunk,
//    no register staging, no transposing store. Columns past K and rows
//    without a pool row are zero-filled by the copy.
//  - Row pointers resolved ahead. The dependent lookups key -> owner/slot
//    -> row pointer run as a register pipeline in 128 threads: a tile's
//    keys are loaded two tiles ahead, its owner/slot one tile ahead, and
//    its pointers are written to a shared table (8 tile slots) before
//    the chunk copies that read them are issued, so no lookup stalls the
//    FMA pipe.
//  - A larger register tile. Thread (tx, ty) holds candidates
//    tx + 16*j (j < 8) against queries TQ*ty + i (i < TQ) on both sides:
//    64 accumulators at TQ = 4 (254 registers), fed per four k by eight
//    16-byte candidate reads (pitch 68: the 8 lanes of a phase hit 8
//    distinct bank quads) and 2*TQ broadcast query reads; the k loop of
//    a chunk is unrolled 4 of 16 (fully unrolled ran 1-2% slower). A
//    warp of 8 candidate lanes x 4 query groups, one wavefront per
//    read, measured no faster (scripts/k4_variants.py).
//  - Counts. Each thread keeps integer counts across all of its CTA's
//    tiles; at the end a half-warp shuffle sums them and one integer
//    atomicAdd per query and side per CTA lands them, independent of the
//    order of the CTAs.
// Each dot is one __fmaf_rn chain in k order, then fma(0, 0, acc) over
// the zero-filled columns, which leaves it unchanged: on integer-valued
// data every order gives the same sums, and elsewhere the counts differ
// from any other f32 evaluation only at near-ties (ops/kernels.py
// pool_eval_counts_plain).
//
// The pair form (pair_pool_eval_counts_kernel). Where no resident block
// holds all B queries of both sides, the form above splits them over
// blockIdx.y: at K=512 (ComplEx at 256 complex dimensions) B=64 takes two
// blocks of 32, and each thread holds 8 x 2 x 2 = 32 accumulators, 12
// shared reads for 128 FMAs (0.54 of the bound at 4,594,485 candidates).
// The pair form gives each CTA one side instead: CTA (x, 0) holds all 64
// object-side query rows resident (q_o, okey), CTA (x, 1) the subject
// side's (q_s, skey), 128 KiB each at K=512, and both walk the same
// 256-row tiles x, x + gridDim.x, ... Each thread holds 8 candidates
// (lane + 32j) x 8 queries (warp) = 64 accumulators, 16 shared reads for
// 256 FMAs; the ring is 2 stages of 256 rows x 32 columns (pitch 36: the
// 8 lanes of a phase hit 8 distinct bank quads), fed by every thread's
// 16-byte cp.async, 8 threads a 128-byte row segment, with the key ->
// owner/slot -> pointer pipeline of the form above. What bounds it is the
// same f32 FMA rate; each row is read by both CTAs of its slice, the
// second read mostly from L2 (they run together: one wave of 2 x 66 CTAs).
// Measured at the eval cell's shape (PERF.md): 15.2 ms against
// 16.6 for the split form and 8.99 for the bound; the loads cost nothing
// measurable (with no candidate loaded past the first stage it runs as
// fast), the FMA loop with its barrier per 32 columns is what remains.
// Tried there and not kept: a cluster of the two CTAs fed by one
// cp.async.bulk a row and chunk with .multicast::cluster (each row read
// once): 27.5-28.0 ms, the bulk copies cost ~50 ns each per SM, whatever
// their size (128 or 64 bytes); a producer warp with mbarriers, CTA-local
// or across the cluster (22.3 and 16.7 ms without any loads: one warp's
// issue and the handshake on the critical path of a 2-stage ring that
// the 128 KiB of queries leave room for); 16 x 8 accumulators over
// 512-row tiles of 16 columns (15.9 ms). The arithmetic is the form
// above's: one __fmaf_rn chain in k order a dot, then the zero-filled
// tail, so its counts are bitwise the other form's. The form above stays
// where one resident block holds all B queries (K <= 256 at B <= 64):
// each row is read once already, and no alignment is needed; the pair
// form needs 16-byte rows and queries and B <= 64, and one side's
// queries fit beside its ring up to K = 544.
#include <cuda_runtime.h>

namespace {

constexpr int kCt = 128;        // candidates per tile
constexpr int kKC = 64;         // columns per ring stage
constexpr int kPitch = kKC + 4; // floats per ring row (272 B)
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr int kSlots = 8;       // tile slots of the pointer/key tables

struct Args {
  const float* pool;
  int shards, slots, L, K;
  const int* owner;
  const int* slot;
  long long num_keys;
  const int* keys;
  long long nvalid;
  const float* q_o;
  const float* q_s;
  const float* true_sc;
  const int* okey;
  const int* skey;
  int B;
  int* g_o;
  int* g_s;
  int resident;
};

// bytes of dynamic shared memory the kernel lays out (must match
// ops/kernels.py _k4_smem)
long long smem_need(int Bq, int K, int resident) {
  const long long kp = (long long)((K + kKC - 1) / kKC) * kKC;
  const long long q = resident ? 2LL * kp * Bq : (long long)kStages * 2 * kKC * Bq;
  return (long long)kSlots * kCt * (8 + 4) +
         ((long long)kStages * kCt * kPitch + q) * 4;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy query columns [k0, k0 + 4*nkg) of the block's Bq queries, both
// sides, into dst_o/dst_s laid out [nkg][Bq][4]; zero past B and K.
template <int Bq, bool kVec>
__device__ __forceinline__ void copy_queries(const Args& a, int q0, int k0,
                                             int nkg, float* dst_o,
                                             float* dst_s, int tid) {
  const int n = nkg * Bq;
  for (int e = tid; e < n; e += kThreads) {
    const int kg = e / Bq, b = e - kg * Bq;
    const int qb = q0 + b, k = k0 + 4 * kg;
    const bool inb = qb < a.B;
    const long long off = inb ? (long long)qb * a.K + k : 0;
    float* d_o = dst_o + 4 * e;
    float* d_s = dst_s + 4 * e;
    if (kVec) {
      const int bytes = inb && k < a.K ? 16 : 0;
      cp16(d_o, bytes ? a.q_o + off : a.q_o, bytes);
      cp16(d_s, bytes ? a.q_s + off : a.q_s, bytes);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int bytes = inb && k + kk < a.K ? 4 : 0;
        cp4(d_o + kk, bytes ? a.q_o + off + kk : a.q_o, bytes);
        cp4(d_s + kk, bytes ? a.q_s + off + kk : a.q_s, bytes);
      }
    }
  }
}

template <int TQ, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    pool_eval_counts_kernel(const Args a) {
  constexpr int Bq = 16 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const float** s_ptr = reinterpret_cast<const float**>(smem);  // [8][128]
  int* s_key = reinterpret_cast<int*>(smem + kSlots * kCt * 8);  // [8][128]
  float* ring = reinterpret_cast<float*>(smem + kSlots * kCt * 12);
  float* qbuf = ring + kStages * kCt * kPitch;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.y * Bq;
  const int nkc = (a.K + kKC - 1) / kKC;
  const int kp = nkc * kKC;
  const long long ntiles = (a.nvalid + kCt - 1) / kCt;
  const long long first = blockIdx.x, step = gridDim.x;
  if (first >= ntiles) return;
  const int my_tiles = (int)((ntiles - 1 - first) / step + 1);
  const int total = my_tiles * nkc;

  // -- row-pointer pipeline (threads < 128, one candidate row each)
  auto key_of = [&](int i) -> int {
    if (i >= my_tiles) return -1;
    const long long c = (first + (long long)i * step) * kCt + tid;
    return c < a.nvalid ? a.keys[c] : -1;
  };
  auto in_table = [&](int key) { return key >= 0 && key < a.num_keys; };
  auto row_ptr = [&](int sh, int sl) -> const float* {
    return (sh >= 0 && sh < a.shards && sl >= 0 && sl < a.slots)
               ? a.pool + ((long long)sh * a.slots + sl) * (long long)a.L
               : nullptr;
  };
  // key_a/own_a/sl_a: tile i+1; key_b: tile i+2 (at event i)
  int key_a = -1, own_a = -1, sl_a = -1, key_b = -1;
  if (tid < kCt) {
    const int k0 = key_of(0);
    s_ptr[tid] = in_table(k0) ? row_ptr(a.owner[k0], a.slot[k0]) : nullptr;
    s_key[tid] = k0;
    key_a = key_of(1);
    own_a = in_table(key_a) ? a.owner[key_a] : -1;
    sl_a = in_table(key_a) ? a.slot[key_a] : -1;
    key_b = key_of(2);
  }
  // event i: tile i's chunks are about to be issued; publish tile i+1's
  // pointers and move the pipeline on by one tile
  auto event = [&](int i) {
    if (tid >= kCt) return;
    const int sl8 = (i + 1) % kSlots;
    s_ptr[sl8 * kCt + tid] = row_ptr(own_a, sl_a);
    s_key[sl8 * kCt + tid] = key_a;
    key_a = key_b;
    own_a = in_table(key_a) ? a.owner[key_a] : -1;
    sl_a = in_table(key_a) ? a.slot[key_a] : -1;
    key_b = key_of(i + 3);
  };

  if (a.resident)
    copy_queries<Bq, kVec>(a, q0, 0, kp / 4, qbuf, qbuf + kp * Bq, tid);

  // issue the copies of stage s (tile s / nkc, chunk s % nkc) into ring
  // slot s % kStages; always one commit group, empty past the end
  int is_tile = 0, is_kc = 0;
  auto issue = [&](int s) {
    if (s < total) {
      if (is_kc == 0) event(is_tile);
      const int slot = s % kStages;
      float* dst = ring + slot * kCt * kPitch;
      const float* const* ptr = s_ptr + (is_tile % kSlots) * kCt;
      const int c0 = is_kc * kKC;
      if (kVec) {
#pragma unroll
        for (int m = 0; m < kCt * kKC / 4 / kThreads; ++m) {
          const int e = tid + kThreads * m;
          const int r = e / (kKC / 4), cc = 4 * (e % (kKC / 4));
          const float* p = ptr[r];
          const int bytes = p != nullptr && c0 + cc < a.K ? 16 : 0;
          cp16(dst + r * kPitch + cc, bytes ? p + c0 + cc : a.pool, bytes);
        }
      } else {
#pragma unroll 4
        for (int m = 0; m < kCt * kKC / kThreads; ++m) {
          const int e = tid + kThreads * m;
          const int r = e / kKC, cc = e % kKC;
          const float* p = ptr[r];
          const int bytes = p != nullptr && c0 + cc < a.K ? 4 : 0;
          cp4(dst + r * kPitch + cc, bytes ? p + c0 + cc : a.pool, bytes);
        }
      }
      if (!a.resident) {
        float* qo = qbuf + slot * 2 * kKC * Bq;
        copy_queries<Bq, kVec>(a, q0, c0, kKC / 4, qo, qo + kKC * Bq, tid);
      }
      if (++is_kc == nkc) { is_kc = 0; ++is_tile; }
    }
    cp_commit();
  };

  // this thread's queries: TQ*ty + i
  float t[TQ];
  int ok[TQ], sk[TQ], cnt_o[TQ], cnt_s[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qb = q0 + TQ * ty + i;
    const bool in = qb < a.B;
    t[i] = in ? a.true_sc[qb] : 0.f;
    ok[i] = in ? a.okey[qb] : -1;
    sk[i] = in ? a.skey[qb] : -1;
    cnt_o[i] = cnt_s[i] = 0;
  }
  __syncthreads();  // tile 0's pointer table
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    __syncthreads();  // the event's table writes, before the next issue
  }

  float acc_o[8][TQ], acc_s[8][TQ];
  int tile = 0, kc = 0;
  for (int s = 0; s < total; ++s) {
    cp_wait<kStages - 2>();  // stage s (and the resident queries) landed
    __syncthreads();         // ... for every thread; slot s-1 is free
    issue(s + kStages - 1);

    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc_o[j][i] = acc_s[j][i] = 0.f;
    }
    const int slot = s % kStages;
    const float* cr = ring + slot * kCt * kPitch + tx * kPitch;
    const float* qo = a.resident ? qbuf + kc * kKC * Bq
                                 : qbuf + slot * 2 * kKC * Bq;
    const float* qs = qo + (a.resident ? kp * Bq : kKC * Bq);
#pragma unroll 4  // 4 of the 16 (see the note at the top)
    for (int kg = 0; kg < kKC / 4; ++kg) {
      float4 r[8], qa[TQ], qb[TQ];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = *reinterpret_cast<const float4*>(cr + 16 * j * kPitch + 4 * kg);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int o = 4 * (kg * Bq + TQ * ty + i);
        qa[i] = *reinterpret_cast<const float4*>(qo + o);
        qb[i] = *reinterpret_cast<const float4*>(qs + o);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          acc_o[j][i] = __fmaf_rn(qa[i].x, r[j].x, acc_o[j][i]);
          acc_s[j][i] = __fmaf_rn(qb[i].x, r[j].x, acc_s[j][i]);
          acc_o[j][i] = __fmaf_rn(qa[i].y, r[j].y, acc_o[j][i]);
          acc_s[j][i] = __fmaf_rn(qb[i].y, r[j].y, acc_s[j][i]);
          acc_o[j][i] = __fmaf_rn(qa[i].z, r[j].z, acc_o[j][i]);
          acc_s[j][i] = __fmaf_rn(qb[i].z, r[j].z, acc_s[j][i]);
          acc_o[j][i] = __fmaf_rn(qa[i].w, r[j].w, acc_o[j][i]);
          acc_s[j][i] = __fmaf_rn(qb[i].w, r[j].w, acc_s[j][i]);
        }
    }

    if (kc == nkc - 1) {  // the tile's dots are whole: compare and count
      const int* keys = s_key + (tile % kSlots) * kCt;
      const long long cbase = (first + (long long)tile * step) * kCt;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = tx + 16 * j;
        const int key = keys[cl];
        const bool v = cbase + cl < a.nvalid;
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          cnt_o[i] += v & (acc_o[j][i] > t[i]) & (key != ok[i]);
          cnt_s[i] += v & (acc_s[j][i] > t[i]) & (key != sk[i]);
        }
      }
      kc = 0;
      ++tile;
    } else {
      ++kc;
    }
  }
  cp_wait<0>();

  // sum over the 16 candidate lanes of a half-warp (lanes sharing ty)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      cnt_o[i] += __shfl_xor_sync(0xffffffffu, cnt_o[i], off);
      cnt_s[i] += __shfl_xor_sync(0xffffffffu, cnt_s[i], off);
    }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qb = q0 + TQ * ty + i;
      if (qb >= a.B) continue;
      if (cnt_o[i]) atomicAdd(a.g_o + qb, cnt_o[i]);
      if (cnt_s[i]) atomicAdd(a.g_s + qb, cnt_s[i]);
    }
  }
}

template <int TQ, bool kVec>
int launch(const Args& a, int smem, dim3 grid, cudaStream_t stream) {
  auto* k = pool_eval_counts_kernel<TQ, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_tq(const Args& a, int Bq, int smem, dim3 grid,
              cudaStream_t stream) {
  switch (Bq) {
    case 16: return launch<1, kVec>(a, smem, grid, stream);
    case 32: return launch<2, kVec>(a, smem, grid, stream);
    case 48: return launch<3, kVec>(a, smem, grid, stream);
    case 64: return launch<4, kVec>(a, smem, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the pair form ----
constexpr int kPairCt = 256;         // candidates per tile
constexpr int kPairKC = 32;          // columns per ring stage
constexpr int kPairPitch = kPairKC + 4;  // floats per ring row (144 B)
constexpr int kPairQ = 64;           // query rows of a side
constexpr int kPairSlots = 4;        // tile slots of the pointer/key tables
constexpr int kPairThreads = 256;    // 8 warps, a query group each
constexpr int kTC = kPairCt / 32;    // candidates a thread: lane + 32j
constexpr int kTQ = kPairQ / 8;      // queries a thread: 8*warp + i

// bytes of dynamic shared memory one CTA of the pair form lays out (must
// match ops/kernels.py _k4_pair_smem)
long long pair_smem_need(int K) {
  const long long kp = (long long)((K + kPairKC - 1) / kPairKC) * kPairKC;
  return (long long)kPairSlots * kPairCt * (8 + 4) + 2 * kPairQ * 4 +
         ((long long)kStages * kPairCt * kPairPitch + kp * kPairQ) * 4;
}

// One CTA of a pair: side blockIdx.y (0: object, q_o/okey; 1: subject,
// q_s/skey) over the candidate tiles blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(kPairThreads, 1)
    pair_pool_eval_counts_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float** s_ptr = reinterpret_cast<const float**>(smem);  // [4][256]
  int* s_key = reinterpret_cast<int*>(s_ptr + kPairSlots * kPairCt);
  float* s_true = reinterpret_cast<float*>(s_key + kPairSlots * kPairCt);
  int* s_side = reinterpret_cast<int*>(s_true + kPairQ);
  float* ring = reinterpret_cast<float*>(s_side + kPairQ);
  float* qbuf = ring + kStages * kPairCt * kPairPitch;  // [kp/4][64][4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int side = blockIdx.y;
  const int nkc = (a.K + kPairKC - 1) / kPairKC;
  const long long ntiles = (a.nvalid + kPairCt - 1) / kPairCt;
  const long long first = blockIdx.x, step = gridDim.x;
  if (first >= ntiles) return;
  const int my_tiles = (int)((ntiles - 1 - first) / step + 1);
  const int total = my_tiles * nkc;

  // -- row-pointer pipeline (thread tid: row tid of each tile), as the
  // one-CTA-a-block form's
  auto key_of = [&](int i) -> int {
    if (i >= my_tiles) return -1;
    const long long c = (first + (long long)i * step) * kPairCt + tid;
    return c < a.nvalid ? a.keys[c] : -1;
  };
  auto in_table = [&](int key) { return key >= 0 && key < a.num_keys; };
  auto row_ptr = [&](int sh, int sl) -> const float* {
    return (sh >= 0 && sh < a.shards && sl >= 0 && sl < a.slots)
               ? a.pool + ((long long)sh * a.slots + sl) * (long long)a.L
               : nullptr;
  };
  // key_a/own_a/sl_a: tile i+1; key_b: tile i+2 (at event i)
  const int k0 = key_of(0);
  s_ptr[tid] = in_table(k0) ? row_ptr(a.owner[k0], a.slot[k0]) : nullptr;
  s_key[tid] = k0;
  int key_a = key_of(1);
  int own_a = in_table(key_a) ? a.owner[key_a] : -1;
  int sl_a = in_table(key_a) ? a.slot[key_a] : -1;
  int key_b = key_of(2);
  // event i: tile i's chunks are about to be issued; publish tile i+1's
  // pointers and move the pipeline on by one tile
  auto event = [&](int i) {
    const int sl = (i + 1) % kPairSlots;
    s_ptr[sl * kPairCt + tid] = row_ptr(own_a, sl_a);
    s_key[sl * kPairCt + tid] = key_a;
    key_a = key_b;
    own_a = in_table(key_a) ? a.owner[key_a] : -1;
    sl_a = in_table(key_a) ? a.slot[key_a] : -1;
    key_b = key_of(i + 3);
  };

  // this CTA's side, resident as [kp/4][64][4], zero past B and K
  const float* q = side ? a.q_s : a.q_o;
  for (int e = tid; e < nkc * kPairKC / 4 * kPairQ; e += kPairThreads) {
    const int kg = e / kPairQ, b = e - kg * kPairQ;
    const int bytes = b < a.B && 4 * kg < a.K ? 16 : 0;
    cp16(qbuf + 4 * e, bytes ? q + (long long)b * a.K + 4 * kg : q, bytes);
  }
  if (tid < kPairQ) {
    s_true[tid] = tid < a.B ? a.true_sc[tid] : 0.f;
    s_side[tid] = tid < a.B ? (side ? a.skey : a.okey)[tid] : -1;
  }

  // issue the copies of chunk s (tile s / nkc, columns (s % nkc) * 32)
  // into ring stage s % kStages, 8 threads a row; always one commit group
  int is_tile = 0, is_kc = 0;
  auto issue = [&](int s) {
    if (s < total) {
      if (is_kc == 0) event(is_tile);
      float* dst = ring + (s % kStages) * kPairCt * kPairPitch;
      const float* const* ptr = s_ptr + (is_tile % kPairSlots) * kPairCt;
      const int c0 = is_kc * kPairKC;
#pragma unroll
      for (int m = 0; m < kPairCt * kPairKC / 4 / kPairThreads; ++m) {
        const int e = tid + kPairThreads * m;
        const int r = e / (kPairKC / 4), cc = 4 * (e % (kPairKC / 4));
        const float* p = ptr[r];
        const int bytes = p != nullptr && c0 + cc < a.K ? 16 : 0;
        cp16(dst + r * kPairPitch + cc, bytes ? p + c0 + cc : a.pool, bytes);
      }
      if (++is_kc == nkc) { is_kc = 0; ++is_tile; }
    }
    cp_commit();
  };

  __syncthreads();  // tile 0's pointer table
  issue(0);
  __syncthreads();  // the event's table writes, before the next issue

  float acc[kTC][kTQ];
  int cnt[kTQ];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) cnt[i] = 0;
  const float* qw = qbuf + 4 * kTQ * warp;
  int tile = 0, kc = 0;
  for (int s = 0; s < total; ++s) {
    cp_wait<0>();     // chunk s (and the queries) landed
    __syncthreads();  // ... for every thread; stage s-1 is free
    issue(s + 1);

    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < kTC; ++j)
#pragma unroll
        for (int i = 0; i < kTQ; ++i) acc[j][i] = 0.f;
    }
    const float* cr = ring + (s % kStages) * kPairCt * kPairPitch +
                      lane * kPairPitch;
    const float* qc = qw + kc * kPairKC * kPairQ;
#pragma unroll
    for (int kg = 0; kg < kPairKC / 4; ++kg) {
      float4 qv[kTQ];
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qc + 4 * (kg * kPairQ + i));
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const float4 r = *reinterpret_cast<const float4*>(
            cr + 32 * j * kPairPitch + 4 * kg);
#pragma unroll
        for (int i = 0; i < kTQ; ++i) {
          acc[j][i] = __fmaf_rn(qv[i].x, r.x, acc[j][i]);
          acc[j][i] = __fmaf_rn(qv[i].y, r.y, acc[j][i]);
          acc[j][i] = __fmaf_rn(qv[i].z, r.z, acc[j][i]);
          acc[j][i] = __fmaf_rn(qv[i].w, r.w, acc[j][i]);
        }
      }
    }

    if (kc == nkc - 1) {  // the tile's dots are whole: compare and count
      const int* keys = s_key + (tile % kPairSlots) * kPairCt;
      const long long cb = (first + (long long)tile * step) * kPairCt;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int cl = lane + 32 * j;
        const int key = keys[cl];
        const bool v = cb + cl < a.nvalid;
#pragma unroll
        for (int i = 0; i < kTQ; ++i) {
          const int qb = kTQ * warp + i;
          cnt[i] += v & (acc[j][i] > s_true[qb]) & (key != s_side[qb]);
        }
      }
      kc = 0;
      ++tile;
    } else {
      ++kc;
    }
  }
  cp_wait<0>();

  // sum over the warp's 32 candidate lanes
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
      cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], off);
  if (lane == 0) {
    int* g = side ? a.g_s : a.g_o;
#pragma unroll
    for (int i = 0; i < kTQ; ++i) {
      const int qb = kTQ * warp + i;
      if (qb < a.B && cnt[i]) atomicAdd(g + qb, cnt[i]);
    }
  }
}

}  // namespace

// g_o/g_s must be zeroed by the caller; the kernel adds into them. The
// launch plan (Bq, stages, smem bytes, grid, resident) comes from
// ops/kernels.py _k4_plan; a plan this source cannot run is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int adapm_pool_eval_counts(
    const float* pool, int shards, int slots, int L, int K, const int* owner,
    const int* slot, long long num_keys, const int* keys, long long nvalid,
    const float* q_o, const float* q_s, const float* true_sc,
    const int* okey, const int* skey, int B, int vec, int Bq, int stages,
    int smem_bytes, int grid_x, int grid_y, int resident, int* g_o, int* g_s,
    cudaStream_t stream) {
  if (nvalid <= 0 || B <= 0) return 0;
  if (stages != kStages || grid_x <= 0 || grid_y <= 0 ||
      (long long)grid_y * Bq < B ||
      smem_bytes < smem_need(Bq, K, resident))
    return (int)cudaErrorInvalidValue;
  const Args a{pool, shards, slots, L,  K,     owner,  slot, num_keys,
               keys, nvalid, q_o,   q_s, true_sc, okey, skey, B,
               g_o,  g_s,    resident};
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  return vec ? launch_tq<true>(a, Bq, smem_bytes, grid, stream)
             : launch_tq<false>(a, Bq, smem_bytes, grid, stream);
}

// The pair form: grid (grid_x, 2) of 256 threads, one CTA a candidate
// slice and side, with smem_bytes of dynamic shared memory each (ops/
// kernels.py _k4_plan). Needs B <= 64, K and L multiples of 4, and the
// pool and query rows 16-byte aligned; else cudaErrorInvalidValue, before
// anything is launched.
extern "C" int adapm_pool_eval_counts_pair(
    const float* pool, int shards, int slots, int L, int K, const int* owner,
    const int* slot, long long num_keys, const int* keys, long long nvalid,
    const float* q_o, const float* q_s, const float* true_sc,
    const int* okey, const int* skey, int B, int smem_bytes, int grid_x,
    int* g_o, int* g_s, cudaStream_t stream) {
  if (nvalid <= 0 || B <= 0) return 0;
  const auto a16 = [](const void* p) {
    return ((unsigned long long)p & 15) == 0;
  };
  if (B > kPairQ || K <= 0 || K % 4 || L % 4 || !a16(pool) || !a16(q_o) ||
      !a16(q_s) || grid_x <= 0 || smem_bytes < pair_smem_need(K))
    return (int)cudaErrorInvalidValue;
  const Args a{pool, shards, slots, L,  K,     owner,  slot, num_keys,
               keys, nvalid, q_o,   q_s, true_sc, okey, skey, B,
               g_o,  g_s,    1};
  auto* k = pair_pool_eval_counts_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<dim3((unsigned)grid_x, 2), kPairThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}
