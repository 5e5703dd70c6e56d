// K6 sgns_step: the skip-gram negative-sampling (word2vec) training
// step's model math in one launch: the loss, its gradient for every
// role, and the AdaGrad update rows.
//
// Replaces the model math of the JAX package's fused step
// (adapm_tpu/ops/fused.py _build_device_routed_body, and the host-routed
// body at :202: value_and_grad of models/sgns.py sgns_loss, then
// upd = [-lr*g*rsqrt(acc + g^2 + eps) | g^2], :437-445), which XLA
// compiles into the step's one program. The epilogue is the arithmetic
// of the TPU kernel adapm_tpu/ops/pallas_kernels.py adagrad_apply
// (adagrad.cuh upd_one, shared with K2 and K5 instruction for
// instruction).
//
// Per pair b, with c = center, x = ctx and n_k = the N negatives (rows
// [emb d | acc d], f32), pos = c.x and neg_k = c.n_k:
//
//   loss_b = softplus(-pos) + sum_k softplus(neg_k)
//   dpos = -sig(-pos)/B,  dneg_k = sig(neg_k)/B
//   g_c = dpos x + sum_k dneg_k n_k (k in order),  g_x = dpos c,
//   g_{n_k} = dneg_k c.
//
// Each occurrence of a row gets one update row; K3 folds duplicates in
// batch order.
//
// Bound on an H100: bytes. Each gathered row is read once and one update
// row written per row (2,048 bytes a row at d = 128); the arithmetic is
// a few flops per value. Design (a first version: right and simple):
// one warp per pair, 8 pairs per CTA, no shared memory but the N
// coefficients of each pair. Each lane owns W consecutive coordinates
// of a 32*W chunk (W = 4, one float4 of emb and one of acc, when d % 4 == 0 and
// the rows are 16-byte aligned; else W = 1), so at d = 128 a row is one
// float4 per lane. Pass 1 forms the 1 + N dots, each reduced by a fixed
// shuffle butterfly (deterministic, no atomics); every lane then holds
// the dot, forms the coefficient and the loss terms alike. Pass 2 reads
// the emb halves again (from L1) with the accumulator halves and writes
// each row's gradient and update row once. Frozen roles (a null update
// pointer) are read and never written.
#include <cuda_runtime.h>

#include "adagrad.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Role {
  const float* rows;  // gathered rows [emb d | acc d]
  long long stride;   // floats between consecutive rows
  float* upd;         // [n, 2d] update rows, or null (frozen role)
  float* grad;        // [n, d] gradient rows, or null
};

struct Args {
  Role c, x, neg;  // neg row (b, k) is row b*N + k
  float* loss;     // [B] per-pair loss
  const float* lr_eps;
  int B, N, d;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// log(1 + e^x) = logaddexp(x, 0), as models/sgns.py computes it
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

template <int W>
__device__ __forceinline__ void load(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int W>
__device__ __forceinline__ float dot_part(const float (&a)[W],
                                          const float (&b)[W]) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < W; ++j) s += a[j] * b[j];
  return s;
}

// Coordinates k..k+W-1 of one row's gradient: the optional gradient
// output, then the AdaGrad epilogue on the row's accumulator half.
template <int W>
__device__ __forceinline__ void emit(const Role& role, long long row,
                                     const float* src, int k, int d,
                                     const float (&g)[W], float lr,
                                     float eps) {
  if (role.grad != nullptr) store<W>(role.grad + row * d + k, g);
  if (role.upd == nullptr) return;
  float acc[W], u[W], q[W];
  load<W>(src + d + k, acc);
#pragma unroll
  for (int j = 0; j < W; ++j)
    adapm::upd_one(g[j], acc[j], lr, eps, &u[j], &q[j]);
  float* o = role.upd + row * 2 * d;
  store<W>(o + k, u);
  store<W>(o + d + k, q);
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    sgns_step_kernel(const Args a) {
  extern __shared__ float dyn[];  // [kWarps][N]: dneg_k of each warp's pair
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= a.B) return;  // whole warps only: no block-wide barrier below
  const int N = a.N, d = a.d;
  float* coef = dyn + warp * N;
  const float* C = a.c.rows + b * a.c.stride;
  const float* X = a.x.rows + b * a.x.stride;
  const long long n0 = b * N;
  const int step = 32 * W;
  const float invB = 1.0f / (float)a.B;

  // -- pass 1: the dots, the coefficients and the loss
  float s = 0.0f;
  for (int k = lane * W; k < d; k += step) {
    float c[W], x[W];
    load<W>(C + k, c);
    load<W>(X + k, x);
    s += dot_part<W>(c, x);
  }
  const float pos = warp_sum(s);
  const float dpos = -sigmoid(-pos) * invB;
  float lneg = 0.0f;
  for (int n = 0; n < N; ++n) {
    const float* R = a.neg.rows + (n0 + n) * a.neg.stride;
    s = 0.0f;
    for (int k = lane * W; k < d; k += step) {
      float c[W], v[W];
      load<W>(C + k, c);
      load<W>(R + k, v);
      s += dot_part<W>(c, v);
    }
    const float dn = warp_sum(s);
    lneg += softplus(dn);
    if (lane == 0) coef[n] = sigmoid(dn) * invB;
  }
  if (lane == 0) a.loss[b] = softplus(-pos) + lneg;
  __syncwarp();

  // -- pass 2: gradients and the AdaGrad epilogue
  const float lr = __ldg(a.lr_eps), eps = __ldg(a.lr_eps + 1);
  for (int k = lane * W; k < d; k += step) {
    float c[W], x[W], gc[W], gx[W];
    load<W>(C + k, c);
    load<W>(X + k, x);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      gc[j] = dpos * x[j];
      gx[j] = dpos * c[j];
    }
    for (int n = 0; n < N; ++n) {
      const float cn = coef[n];
      const float* R = a.neg.rows + (n0 + n) * a.neg.stride;
      float v[W], gn[W];
      load<W>(R + k, v);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        gc[j] += cn * v[j];
        gn[j] = cn * c[j];
      }
      emit<W>(a.neg, n0 + n, R, k, d, gn, lr, eps);
    }
    emit<W>(a.x, b, X, k, d, gx, lr, eps);
    emit<W>(a.c, b, C, k, d, gc, lr, eps);
  }
}

}  // namespace

extern "C" int adapm_sgns_step(
    const float* c, long long c_stride, float* c_upd, float* c_grad,
    const float* x, long long x_stride, float* x_upd, float* x_grad,
    const float* neg, long long neg_stride, float* neg_upd, float* neg_grad,
    float* loss, const float* lr_eps, int B, int N, int d, int vec,
    cudaStream_t stream) {
  if (B <= 0 || d <= 0) return 0;
  Args a;
  a.c = Role{c, c_stride, c_upd, c_grad};
  a.x = Role{x, x_stride, x_upd, x_grad};
  a.neg = Role{neg, neg_stride, neg_upd, neg_grad};
  a.loss = loss;
  a.lr_eps = lr_eps;
  a.B = B;
  a.N = N;
  a.d = d;
  const int grid = (B + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * (N > 0 ? N : 1);
  if (vec)
    sgns_step_kernel<4><<<grid, kWarps * 32, smem, stream>>>(a);
  else
    sgns_step_kernel<1><<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
