// K16 rescal_step: the RESCAL training step's model math in one launch:
// the loss, its gradient for every role, and the AdaGrad update rows.
//
// Replaces the model math of the JAX package's fused step
// (adapm_tpu/ops/fused.py _build_device_routed_body: value_and_grad of
// models/kge.py make_kge_loss("rescal", T, l2) with :31 rescal_score,
// then upd = [-lr*g*rsqrt(acc + g^2 + eps) | g^2]), which XLA compiles
// into the step's one program. Its epilogue is K2's arithmetic
// (adagrad.cuh, shared with K2 instruction for instruction).
//
// Per triple b, with s, o and the negatives n_k (k < N) entity halves of
// d floats and R = r.reshape(d, d) (row-major, d^2 floats):
//
//   u = R o,  v = R^T s,  pos = s.u,  ns_k = n_k.u,  no_k = v.n_k
//   loss_b = softplus(-pos) + sum_k w^s_k softplus(ns_k)
//          + sum_k w^o_k softplus(no_k) [+ l2 (|s|^2 + |r|^2 + |o|^2)]
//
// with w = 1, or softmax(T * score) over k (a stopped gradient) when
// T > 0; the batch loss is the mean over B. With dpos = -sig(-pos)/B,
// dns_k = w^s_k sig(ns_k)/B, dno_k = w^o_k sig(no_k)/B,
// x = sum_k dns_k n_k and y = sum_k dno_k n_k:
//
//   g_s   = dpos u + R y                      (+ 2 l2 s / B)
//   g_o   = dpos v + R^T x                    (+ 2 l2 o / B)
//   g_n_k = dns_k u + dno_k v
//   g_R   = (dpos s + x) o^T + s y^T          (+ 2 l2 R / B)
//
// three outer products: the [N, d, d] intermediate of the score's
// einsum is never formed. A duplicated key gets one update row per
// occurrence; K3 folds them in batch order. The l2 terms are added only
// when l2 > 0.
//
// Bound on an H100: bytes. Each triple reads its s, o, r and N negative
// rows once ([emb | acc]) and writes one update row ([upd | g^2]) for
// each: (4d + 2d^2 + 2Nd) f32 twice, 331,776 bytes at d = 128, N = 32;
// the arithmetic is ~10 d^2 + 8 N d flops, far below the card's f32
// rate, and matrix-vector products and rank-2 updates leave tensor cores
// nothing to do. Design (a first version: right and simple): one CTA of
// 256 threads per triple. The embedding halves of r (d^2 floats, 64 KiB
// at d = 128), s, o and the negatives are copied into shared memory
// with cp.async (16-byte copies when d % 4 == 0 and the rows are
// aligned), so every load of the triple is in flight at once. Pass 1:
// u (a warp per row of R) and v (column sums, the rows split over
// thread groups whose partial sums are added in a fixed order), then the
// 2N + 1 dots (and the squared norms when l2 > 0), each by one warp
// with a fixed shuffle butterfly; one warp computes the weights,
// sigmoids and the loss; then x, y and a = dpos s + x per coordinate (a
// loop over k in order). Pass 2: R y and R^T x the same way, then the
// rows of s, o and the negatives. Pass 3 streams R's accumulator half
// from global memory, coalesced, and writes the relation's update row;
// each of the d^2 elements is read once and written once. No atomics,
// so two runs are bitwise equal. Frozen roles (a null update pointer)
// are read and never written. The kernel allocates nothing: its only
// output besides the update rows is the [B] loss its wrapper makes.
// Shared memory is d^2 + (N + 9) d + max(1024, d) + 4N + 5 + 8 floats
// (adapm_rescal_step_smem), 91,188 bytes at d = 128, N = 32: two CTAs
// per SM.
#include <cuda_runtime.h>

#include "adagrad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Role {
  const float* rows;  // gathered rows [emb D | acc D]
  long long stride;   // floats between consecutive rows
  float* upd;         // [n, 2D] update rows, or null (frozen role)
  float* grad;        // [n, D] gradient rows, or null
};

struct Args {
  Role s, r, o, neg;  // neg row (b, k) is row b*N + k
  float* loss;        // [B] per-triple loss
  const float* lr_eps;
  int B, N, d;
  float temp, l2;
};

// floats of the column sums' partials: P row groups of d columns
__host__ __device__ inline int part_floats(int d) {
  return d > 4 * kThreads ? d : 4 * kThreads;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// log(1 + e^x) = logaddexp(x, 0), as models/kge.py computes it
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

// x.y over d floats by one warp: lane partials in a fixed order, then the
// butterfly; every lane returns the sum
template <int W>
__device__ __forceinline__ float warp_dot(const float* x, const float* y,
                                          int d, int lane) {
  float acc = 0.0f;
  for (int j = lane * W; j < d; j += 32 * W) {
    if constexpr (W == 4) {
      const float4 a = *reinterpret_cast<const float4*>(x + j);
      const float4 b = *reinterpret_cast<const float4*>(y + j);
      acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    } else {
      acc += x[j] * y[j];
    }
  }
  return warp_sum(acc);
}

// out[i] = sum_j M[i][j] vec[j]: a warp per row
template <int W>
__device__ __forceinline__ void row_matvec(const float* M, const float* vec,
                                           float* out, int d, int warp,
                                           int lane) {
  for (int i = warp; i < d; i += kWarps) {
    const float acc = warp_dot<W>(M + (long long)i * d, vec, d, lane);
    if (lane == 0) out[i] = acc;
  }
}

// out[j] = sum_i vec[i] M[i][j]: thread t sums column group t % G (W
// columns) over rows t / G, t / G + P, ... (G = d / W groups, P = 256 / G
// row groups), then the P partials of each column in order. Block-wide:
// every thread calls it; it ends on a barrier.
template <int W>
__device__ __forceinline__ void col_matvec(const float* M, const float* vec,
                                           float* out, float* part, int d,
                                           int tid) {
  const int G = d / W;
  const int P = G >= kThreads ? 1 : kThreads / G;
  for (int t = tid; t < P * G; t += kThreads) {
    const int c = (t % G) * W, p = t / G;
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    for (int i = p; i < d; i += P) {
      const float vi = vec[i];
      if constexpr (W == 4) {
        const float4 m =
            *reinterpret_cast<const float4*>(M + (long long)i * d + c);
        acc[0] += vi * m.x;
        acc[1] += vi * m.y;
        acc[2] += vi * m.z;
        acc[3] += vi * m.w;
      } else {
        acc[0] += vi * M[(long long)i * d + c];
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) part[p * d + c + w] = acc[w];
  }
  __syncthreads();
  for (int j = tid; j < d; j += kThreads) {
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) acc += part[p * d + j];
    out[j] = acc;
  }
  __syncthreads();
}

// The gradient of W consecutive coordinates k..k+W-1 of one row of width
// D: optional gradient output, then the AdaGrad epilogue on the row's
// accumulator half (read from global memory once) into its update row.
template <int W>
__device__ __forceinline__ void emit(const Role& role, long long row, int k,
                                     int D, const float (&g)[W], float lr,
                                     float eps) {
  if (role.grad != nullptr) {
    float* gp = role.grad + row * D + k;
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(gp) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
      gp[0] = g[0];
    }
  }
  if (role.upd == nullptr) return;
  const float* accp = role.rows + row * role.stride + D + k;
  float acc[W], u[W], q[W];
  if constexpr (W == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(accp));
    acc[0] = a.x;
    acc[1] = a.y;
    acc[2] = a.z;
    acc[3] = a.w;
  } else {
    acc[0] = __ldg(accp);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) adapm::upd_one(g[w], acc[w], lr, eps, &u[w],
                                             &q[w]);
  float* up = role.upd + row * 2 * D + k;
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(up) = make_float4(u[0], u[1], u[2], u[3]);
    *reinterpret_cast<float4*>(up + D) = make_float4(q[0], q[1], q[2], q[3]);
  } else {
    up[0] = u[0];
    up[D] = q[0];
  }
}

// W = 4: 16-byte copies, loads and stores (d % 4 == 0, every row 16-byte
// aligned); W = 1: 4-byte elements.
template <int W>
__global__ void __launch_bounds__(kThreads)
    rescal_step_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, d = a.d, dd = d * d;
  const bool reg = a.l2 > 0.0f;
  float* Rm = sm;                            // R [d][d]
  float* S = Rm + dd;                        // s [d]
  float* O = S + d;                          // o [d]
  float* NEG = O + d;                        // n_k [N][d]
  float* u = NEG + (long long)N * d;         // R o
  float* v = u + d;                          // R^T s
  float* x = v + d;                          // sum_k dns_k n_k
  float* y = x + d;                          // sum_k dno_k n_k
  float* av = y + d;                         // dpos s + x
  float* Ry = av + d;                        // R y
  float* Rx = Ry + d;                        // R^T x
  float* part = Rx + d;                      // column-sum partials
  float* dots = part + part_floats(d);  // ns[N], no[N], pos, |s|2, |o|2, |r|2
  float* coef = dots + 2 * N + 4;            // dns[N], dno[N], dpos
  float* red = coef + 2 * N + 1;             // [kWarps] block reduction

  // -- stage the embedding halves: r, then s, o and the negatives
  {
    const int per_r = dd / W, per_e = d / W;
    const int total = per_r + (2 + N) * per_e;
    for (int i = tid; i < total; i += kThreads) {
      const float* src;
      float* dst;
      if (i < per_r) {
        src = a.r.rows + b * a.r.stride + i * W;
        dst = Rm + i * W;
      } else {
        const int j = i - per_r, row = j / per_e, c = (j - row * per_e) * W;
        if (row == 0) src = a.s.rows + b * a.s.stride;
        else if (row == 1) src = a.o.rows + b * a.o.stride;
        else src = a.neg.rows + ((long long)b * N + (row - 2)) * a.neg.stride;
        src += c;
        dst = S + row * d + c;
      }
      if constexpr (W == 4) cp_async16(dst, src);
      else cp_async4(dst, src);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // -- pass 1: u = R o and v = R^T s
  row_matvec<W>(Rm, O, u, d, warp, lane);
  col_matvec<W>(Rm, S, v, part, d, tid);    // ends on a barrier (u too)

  // the dots, a warp each, and |r|^2 over the block when l2 > 0
  const int ndots = 2 * N + 1 + (reg ? 2 : 0);
  for (int j = warp; j < ndots; j += kWarps) {
    const float *p, *q;
    if (j < N) { p = NEG + j * d; q = u; }
    else if (j < 2 * N) { p = NEG + (j - N) * d; q = v; }
    else if (j == 2 * N) { p = S; q = u; }
    else if (j == 2 * N + 1) { p = S; q = S; }
    else { p = O; q = O; }
    const float acc = warp_dot<W>(p, q, d, lane);
    if (lane == 0) dots[j] = acc;
  }
  if (reg) {
    float acc = 0.0f;
    for (int e = tid * W; e < dd; e += kThreads * W) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc += Rm[e + w] * Rm[e + w];
    }
    acc = warp_sum(acc);
    if (lane == 0) red[warp] = acc;
  }
  __syncthreads();

  // -- one warp: weights, sigmoids, the loss and the scales
  if (warp == 0) {
    const float invB = 1.0f / (float)a.B;
    float lsum = 0.0f;
    for (int side = 0; side < 2; ++side) {
      const float* sc = dots + side * N;
      float mx = -__int_as_float(0x7f800000), z = 0.0f;  // -inf
      if (a.temp > 0.0f) {
        for (int k = lane; k < N; k += 32) mx = fmaxf(mx, a.temp * sc[k]);
        mx = warp_max(mx);
        for (int k = lane; k < N; k += 32) z += expf(a.temp * sc[k] - mx);
        z = warp_sum(z);
      }
      for (int k = lane; k < N; k += 32) {
        const float xk = sc[k];
        const float w = a.temp > 0.0f ? expf(a.temp * xk - mx) / z : 1.0f;
        lsum += w * softplus(xk);
        coef[side * N + k] = w * sigmoid(xk) * invB;
      }
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      const float pos = dots[2 * N];
      float l = softplus(-pos) + lsum;
      if (reg) {
        float rr = 0.0f;
        for (int w = 0; w < kWarps; ++w) rr += red[w];
        l += a.l2 * (dots[2 * N + 1] + rr + dots[2 * N + 2]);
      }
      a.loss[b] = l;
      coef[2 * N] = -sigmoid(-pos) * invB;
    }
  }
  __syncthreads();

  // x, y and a = dpos s + x per coordinate (a loop over k in order)
  const float dpos = coef[2 * N];
  for (int j = tid; j < d; j += kThreads) {
    float xs = 0.0f, ys = 0.0f;
    for (int k = 0; k < N; ++k) {
      const float n = NEG[k * d + j];
      xs += coef[k] * n;
      ys += coef[N + k] * n;
    }
    x[j] = xs;
    y[j] = ys;
    av[j] = dpos * S[j] + xs;
  }
  __syncthreads();

  // -- pass 2: R y and R^T x, then the rows of s, o and the negatives
  row_matvec<W>(Rm, y, Ry, d, warp, lane);
  col_matvec<W>(Rm, x, Rx, part, d, tid);   // ends on a barrier (Ry too)
  const float lr = __ldg(a.lr_eps), eps = __ldg(a.lr_eps + 1);
  const float c2 = reg ? 2.0f * a.l2 / (float)a.B : 0.0f;
  for (int k = tid * W; k < d; k += kThreads * W) {
    float gs[W], go[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      gs[w] = dpos * u[k + w] + Ry[k + w];
      go[w] = dpos * v[k + w] + Rx[k + w];
      if (reg) {
        gs[w] += c2 * S[k + w];
        go[w] += c2 * O[k + w];
      }
    }
    emit<W>(a.s, b, k, d, gs, lr, eps);
    emit<W>(a.o, b, k, d, go, lr, eps);
  }
  const int per = d / W;
  for (int i = tid; i < N * per; i += kThreads) {
    const int n = i / per, k = (i - n * per) * W;
    const float cs = coef[n], co = coef[N + n];
    float g[W];
#pragma unroll
    for (int w = 0; w < W; ++w) g[w] = cs * u[k + w] + co * v[k + w];
    emit<W>(a.neg, (long long)b * N + n, k, d, g, lr, eps);
  }

  // -- pass 3: the relation's row, its accumulator half streamed
  if (a.r.upd == nullptr && a.r.grad == nullptr) return;
  for (int e = tid * W; e < dd; e += kThreads * W) {
    const int i = e / d, j = e - i * d;    // W divides d: one row of R
    const float ai = av[i], si = S[i];
    float g[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      g[w] = ai * O[j + w] + si * y[j + w];
      if (reg) g[w] += c2 * Rm[e + w];
    }
    emit<W>(a.r, b, e, dd, g, lr, eps);
  }
}

template <int W>
int launch(const Args& a, int smem, cudaStream_t stream) {
  // raise the kernel's dynamic shared memory cap once per size, outside
  // any stream capture (the first launch of a shape runs eagerly)
  static int cap = 48 * 1024;
  if (smem > cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        rescal_step_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  rescal_step_kernel<W><<<a.B, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes of one CTA at (N, d).
extern "C" long long adapm_rescal_step_smem(int N, int d) {
  return ((long long)d * d + (N + 9LL) * d + part_floats(d) + 4LL * N + 5 +
          kWarps) * 4;
}

extern "C" int adapm_rescal_step(
    const float* s, long long s_stride, float* s_upd, float* s_grad,
    const float* r, long long r_stride, float* r_upd, float* r_grad,
    const float* o, long long o_stride, float* o_upd, float* o_grad,
    const float* neg, long long neg_stride, float* neg_upd, float* neg_grad,
    float* loss, const float* lr_eps, int B, int N, int d, float temp,
    float l2, int vec, cudaStream_t stream) {
  if (B <= 0 || d <= 0) return 0;
  Args a;
  a.s = Role{s, s_stride, s_upd, s_grad};
  a.r = Role{r, r_stride, r_upd, r_grad};
  a.o = Role{o, o_stride, o_upd, o_grad};
  a.neg = Role{neg, neg_stride, neg_upd, neg_grad};
  a.loss = loss;
  a.lr_eps = lr_eps;
  a.B = B;
  a.N = N;
  a.d = d;
  a.temp = temp;
  a.l2 = l2;
  const int smem = (int)adapm_rescal_step_smem(N, d);
  return vec ? launch<4>(a, smem, stream) : launch<1>(a, smem, stream);
}
