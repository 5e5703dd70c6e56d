// K17 pool_eval_dist: the all-entity rank count of the filtered-MRR eval
// for a model whose score is gamma - distance (RotatE, models/kge.py).
//
// Replaces no TPU kernel: the JAX package has no distance model. Added
// because no kernel of the port computes it: RotatE's ranking is not a
// dot product, so K4 (csrc/pool_eval_counts.cu), a GEMM-shaped count,
// cannot. For every query b and every candidate c of the padded
// candidate-key table:
//
//   row_c  = pool[owner[key_c], slot[key_c], :]   ([re d | im d], stride L)
//   dist   = sum_{i<d} |Q[b]_i - row_c,i|          (complex components)
//   g_o[b] += (dist(Q_o[b]) < d_true[b]) & (c < nvalid) & (key_c != okey[b])
//   g_s[b] += (dist(Q_s[b]) < d_true[b]) & (c < nvalid) & (key_c != skey[b])
//
// Q_o = s o r and Q_s = o o conj(r) [B, 2d] are RotatE's query rows
// (|h o r - t| = |h - t o conj(r)| as |r_i| = 1), d_true the true
// triple's distance. Each |q - e| is sqrt((qr - er)^2 + (qi - ei)^2) in
// f32: two subtractions, a multiply, an FMA, a square root (sqrt.approx:
// one special-function-unit op) and an add. The true key is excluded by
// KEY, not by distance. A coordinate outside the pool reads a zero row
// (fill, as K1).
//
// Bound on an H100: the square roots. The special-function unit returns
// 16 results a clock an SM (CUDA C++ Programming Guide, arithmetic
// instruction throughput, compute capability 9.0), against 128 f32
// lanes: a component's one root takes 1/16 of an SM clock, its five f32
// instructions 5/128. At B=64, both sides, d=256 and 4,594,485
// candidates that is 1.51e11 roots, 36 ms at 1.98 GHz; the f32 work
// 13.5 ms and the candidate rows (9.4 GB, read once) 2.8 ms.
//
// Design: K4's pair form with the FMA tile replaced by a distance tile.
// Grid (x, 2 * query blocks) of 256 threads, one CTA an SM: CTA (x, y)
// holds the Bq query rows of block y / 2 of side y % 2 resident in
// shared memory and walks the candidate tiles x, x + gridDim.x, ... of
// 256 rows each. The candidate rows come through a 2-stage cp.async ring
// of 256 rows x 16 components (their 16 real and 16 imaginary parts, as
// [re 4 | im 4] x 4 groups, pitch 36 floats: the 8 lanes of a phase hit
// 8 distinct bank quads), fed by every thread's 16-byte copies (4-byte
// where rows, queries or d are not 16-byte aligned: kVec), with K4's
// key -> owner/slot -> row pointer pipeline a tile ahead. Thread (lane,
// warp) holds candidates lane + 32j (j < 8) against queries TQ*warp + i
// (i < TQ): 8*TQ distance accumulators, fed per 4 components by 16
// 16-byte candidate reads and 2*TQ broadcast query reads, so loads are a
// few per cent of the instructions and the roots run back to back. Each
// distance is one f32 sum in component order; components past d are
// zero in query and row alike, so they add sqrt(0) = 0. Counts are
// integers kept across the CTA's tiles, summed over a warp's lanes and
// added with one atomicAdd a query per warp: independent of the order
// of the CTAs, so two runs give the same counts.
#include <cuda_runtime.h>

namespace {

constexpr int kCt = 256;             // candidates per tile
constexpr int kKC = 16;              // complex components per ring stage
constexpr int kPitch = 2 * kKC + 4;  // floats per ring row (144 B)
constexpr int kStages = 2;
constexpr int kSlots = 4;            // tile slots of the pointer/key tables
constexpr int kThreads = 256;        // 8 warps, a query group each
constexpr int kTC = kCt / 32;        // candidates a thread: lane + 32j

struct Args {
  const float* pool;
  int shards, slots, L, d;
  const int* owner;
  const int* slot;
  long long num_keys;
  const int* keys;
  long long nvalid;
  const float* q_o;
  const float* q_s;
  const float* d_true;
  const int* okey;
  const int* skey;
  int B;
  int* g_o;
  int* g_s;
};

// components padded to whole ring stages
__host__ __device__ inline int padded(int d) {
  return (d + kKC - 1) / kKC * kKC;
}

// bytes of dynamic shared memory one CTA lays out (must match
// ops/kernels.py _k17_smem): the pointer and key tables, the block's true
// distances and side keys, the ring, and the block's Bq query rows
long long smem_need(int Bq, int d) {
  return (long long)kSlots * kCt * (8 + 4) + 2LL * Bq * 4 +
         ((long long)kStages * kCt * kPitch + 2LL * padded(d) * Bq) * 4;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the special-function unit's square root (one MUFU op)
__device__ __forceinline__ float sqrt_sfu(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// |q - e| of one complex component, in the kernel's fixed order
__device__ __forceinline__ float modulus(float qr, float qi, float er,
                                         float ei) {
  const float dr = __fsub_rn(qr, er), di = __fsub_rn(qi, ei);
  return sqrt_sfu(__fmaf_rn(di, di, __fmul_rn(dr, dr)));
}

// Copy the 4 floats of group g (components 4g..4g+3 of a 16-component
// stage starting at c0), part 0 (real) or 1 (imaginary), of row p into
// dst; zero where p is null or the components lie past d.
template <bool kVec>
__device__ __forceinline__ void copy_group(float* dst, const float* p,
                                           const float* any, int d, int c,
                                           int part) {
  if (kVec) {
    const int bytes = p != nullptr && c < d ? 16 : 0;
    cp16(dst, bytes ? p + part * d + c : any, bytes);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int bytes = p != nullptr && c + k < d ? 4 : 0;
      cp4(dst + k, bytes ? p + part * d + c + k : any, bytes);
    }
  }
}

template <int TQ, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    pool_eval_dist_kernel(const Args a) {
  constexpr int Bq = 8 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const float** s_ptr = reinterpret_cast<const float**>(smem);  // [4][256]
  int* s_key = reinterpret_cast<int*>(s_ptr + kSlots * kCt);    // [4][256]
  float* s_true = reinterpret_cast<float*>(s_key + kSlots * kCt);
  int* s_side = reinterpret_cast<int*>(s_true + Bq);
  float* ring = reinterpret_cast<float*>(s_side + Bq);
  float* qbuf = ring + kStages * kCt * kPitch;  // [dp/4][Bq][re 4 | im 4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int side = blockIdx.y & 1, q0 = (blockIdx.y >> 1) * Bq;
  const int dp = padded(a.d), nkc = dp / kKC;
  const long long ntiles = (a.nvalid + kCt - 1) / kCt;
  const long long first = blockIdx.x, step = gridDim.x;
  if (first >= ntiles) return;
  const int my_tiles = (int)((ntiles - 1 - first) / step + 1);
  const int total = my_tiles * nkc;

  // -- row-pointer pipeline (thread tid: row tid of each tile), K4's
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
    const int sl = (i + 1) % kSlots;
    s_ptr[sl * kCt + tid] = row_ptr(own_a, sl_a);
    s_key[sl * kCt + tid] = key_a;
    key_a = key_b;
    own_a = in_table(key_a) ? a.owner[key_a] : -1;
    sl_a = in_table(key_a) ? a.slot[key_a] : -1;
    key_b = key_of(i + 3);
  };

  // this CTA's query rows, resident, zero past B and d
  const float* q = side ? a.q_s : a.q_o;
  for (int e = tid; e < dp / 4 * Bq * 2; e += kThreads) {
    const int part = e & 1, gb = e >> 1, g = gb / Bq, b = gb - g * Bq;
    const float* row = q0 + b < a.B ? q + (long long)(q0 + b) * 2 * a.d
                                    : nullptr;
    copy_group<kVec>(qbuf + 8 * gb + 4 * part, row, q, a.d, 4 * g, part);
  }
  if (tid < Bq) {
    const int qb = q0 + tid;
    s_true[tid] = qb < a.B ? a.d_true[qb] : 0.f;
    s_side[tid] = qb < a.B ? (side ? a.skey : a.okey)[qb] : -1;
  }

  // issue the copies of chunk s (tile s / nkc, components (s % nkc) * 16)
  // into ring stage s % kStages, 8 threads a row; always one commit group
  int is_tile = 0, is_kc = 0;
  auto issue = [&](int s) {
    if (s < total) {
      if (is_kc == 0) event(is_tile);
      float* dst = ring + (s % kStages) * kCt * kPitch;
      const float* const* ptr = s_ptr + (is_tile % kSlots) * kCt;
      const int c0 = is_kc * kKC;
#pragma unroll
      for (int m = 0; m < kCt * 8 / kThreads; ++m) {
        const int e = tid + kThreads * m;
        const int r = e >> 3, part = e & 1, g = (e >> 1) & 3;
        copy_group<kVec>(dst + r * kPitch + 8 * g + 4 * part, ptr[r], a.pool,
                         a.d, c0 + 4 * g, part);
      }
      if (++is_kc == nkc) { is_kc = 0; ++is_tile; }
    }
    cp_commit();
  };

  __syncthreads();  // tile 0's pointer table
  issue(0);
  __syncthreads();  // the event's table writes, before the next issue

  float acc[kTC][TQ];
  int cnt[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) cnt[i] = 0;
  const float* qw = qbuf + 8 * TQ * warp;
  int tile = 0, kc = 0;
  for (int s = 0; s < total; ++s) {
    cp_wait_all();    // chunk s (and the queries) landed
    __syncthreads();  // ... for every thread; stage s-1 is free
    issue(s + 1);

    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < kTC; ++j)
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc[j][i] = 0.f;
    }
    const float* cr = ring + (s % kStages) * kCt * kPitch + lane * kPitch;
    const float* qc = qw + kc * (kKC / 4) * Bq * 8;
#pragma unroll 1
    for (int g = 0; g < kKC / 4; ++g) {
      float4 er[kTC], ei[kTC];
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const float* p = cr + 32 * j * kPitch + 8 * g;
        er[j] = *reinterpret_cast<const float4*>(p);
        ei[j] = *reinterpret_cast<const float4*>(p + 4);
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float* p = qc + 8 * (g * Bq + i);
        const float4 qr = *reinterpret_cast<const float4*>(p);
        const float4 qi = *reinterpret_cast<const float4*>(p + 4);
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          float t = acc[j][i];
          t = __fadd_rn(t, modulus(qr.x, qi.x, er[j].x, ei[j].x));
          t = __fadd_rn(t, modulus(qr.y, qi.y, er[j].y, ei[j].y));
          t = __fadd_rn(t, modulus(qr.z, qi.z, er[j].z, ei[j].z));
          t = __fadd_rn(t, modulus(qr.w, qi.w, er[j].w, ei[j].w));
          acc[j][i] = t;
        }
      }
    }

    if (kc == nkc - 1) {  // the tile's distances are whole: count
      const int* keys = s_key + (tile % kSlots) * kCt;
      const long long cb = (first + (long long)tile * step) * kCt;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int cl = lane + 32 * j;
        const int key = keys[cl];
        const bool v = cb + cl < a.nvalid;
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const int qb = TQ * warp + i;
          cnt[i] += v & (acc[j][i] < s_true[qb]) & (key != s_side[qb]);
        }
      }
      kc = 0;
      ++tile;
    } else {
      ++kc;
    }
  }
  cp_wait_all();

  // sum over the warp's 32 candidate lanes
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], off);
  if (lane == 0) {
    int* g = side ? a.g_s : a.g_o;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qb = q0 + TQ * warp + i;
      if (qb < a.B && cnt[i]) atomicAdd(g + qb, cnt[i]);
    }
  }
}

template <int TQ, bool kVec>
int launch(const Args& a, int smem, dim3 grid, cudaStream_t stream) {
  auto* k = pool_eval_dist_kernel<TQ, kVec>;
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
    case 8: return launch<1, kVec>(a, smem, grid, stream);
    case 16: return launch<2, kVec>(a, smem, grid, stream);
    case 32: return launch<4, kVec>(a, smem, grid, stream);
    case 64: return launch<8, kVec>(a, smem, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// g_o/g_s must be zeroed by the caller; the kernel adds into them. The
// launch plan (Bq, smem bytes, grid) comes from ops/kernels.py _k17_plan:
// grid (grid_x, 2 * ceil(B / Bq)) of 256 threads. vec = 1 needs d and L
// multiples of 4 and the pool and query rows 16-byte aligned. A plan
// this source cannot run is refused with cudaErrorInvalidValue before
// anything is launched.
extern "C" int adapm_pool_eval_dist(
    const float* pool, int shards, int slots, int L, int d, const int* owner,
    const int* slot, long long num_keys, const int* keys, long long nvalid,
    const float* q_o, const float* q_s, const float* d_true,
    const int* okey, const int* skey, int B, int vec, int Bq, int smem_bytes,
    int grid_x, int grid_y, int* g_o, int* g_s, cudaStream_t stream) {
  if (nvalid <= 0 || B <= 0) return 0;
  const auto a16 = [](const void* p) {
    return ((unsigned long long)p & 15) == 0;
  };
  if (d <= 0 || 2LL * d > L || grid_x <= 0 || Bq <= 0 ||
      grid_y != 2 * ((B + Bq - 1) / Bq) || smem_bytes < smem_need(Bq, d) ||
      (vec && (d % 4 || L % 4 || !a16(pool) || !a16(q_o) || !a16(q_s))))
    return (int)cudaErrorInvalidValue;
  const Args a{pool, shards, slots, L,    d,      owner, slot,
               num_keys, keys, nvalid, q_o, q_s, d_true, okey,
               skey, B, g_o, g_s};
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  return vec ? launch_tq<true>(a, Bq, smem_bytes, grid, stream)
             : launch_tq<false>(a, Bq, smem_bytes, grid, stream);
}
