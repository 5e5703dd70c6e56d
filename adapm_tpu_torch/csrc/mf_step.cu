// K7 mf_step: the matrix-factorization training step's model math in
// one launch: the squared loss with L2, its gradient for both factors,
// and the AdaGrad update rows.
//
// Replaces the model math of the JAX package's fused step
// (adapm_tpu/ops/fused.py _build_device_routed_body, and the host-routed
// body at :202: value_and_grad of models/mf.py make_mf_loss(l2), then
// upd = [-lr*g*rsqrt(acc + g^2 + eps) | g^2], :437-445), which XLA
// compiles into the step's one program. The epilogue is the arithmetic
// of the TPU kernel adapm_tpu/ops/pallas_kernels.py adagrad_apply
// (adagrad.cuh upd_one, shared with K2, K5 and K6).
//
// Per rating b, with w, h the row and column factor rows ([factor r |
// acc r], f32) and v the rating:
//
//   e = w.h - v,   loss_b = e^2 + l2 (|w|^2 + |h|^2)
//   g_w = (2e h + 2 l2 w)/B,   g_h = (2e w + 2 l2 h)/B
//
// grouped as ge h + 2 (gr w) with ge = 2e/B and gr = l2/B. Each
// occurrence of a row gets one update row; K3 folds duplicates in batch
// order.
//
// Bound on an H100: bytes (each row read once, one update row written
// per row; a few flops per value). Design, as K6: one warp per rating,
// 8 ratings per CTA; each lane owns W consecutive coordinates of a 32*W
// chunk (W = 4 when r % 4 == 0 and the rows are 16-byte aligned, else
// W = 1). Pass 1 forms w.h, |w|^2 and |h|^2, each reduced by a fixed
// shuffle butterfly (deterministic, no atomics); pass 2 reads the factor
// halves again (from L1) with the accumulator halves and writes each
// row's gradient and update row once. A null update pointer freezes its
// role (read, never written).
#include <cuda_runtime.h>

#include "adagrad.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Role {
  const float* rows;  // gathered rows [factor r | acc r]
  long long stride;   // floats between consecutive rows
  float* upd;         // [B, 2r] update rows, or null (frozen role)
  float* grad;        // [B, r] gradient rows, or null
};

struct Args {
  Role w, h;
  const float* x;  // [B] ratings
  float* loss;     // [B] per-rating loss
  const float* lr_eps;
  int B, d;
  float l2;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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
__global__ void __launch_bounds__(kWarps * 32) mf_step_kernel(const Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= a.B) return;
  const int d = a.d, step = 32 * W;
  const float* Wr = a.w.rows + b * a.w.stride;
  const float* Hr = a.h.rows + b * a.h.stride;

  // -- pass 1: w.h, |w|^2, |h|^2
  float swh = 0.0f, sww = 0.0f, shh = 0.0f;
  for (int k = lane * W; k < d; k += step) {
    float w[W], h[W];
    load<W>(Wr + k, w);
    load<W>(Hr + k, h);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      swh += w[j] * h[j];
      sww += w[j] * w[j];
      shh += h[j] * h[j];
    }
  }
  swh = warp_sum(swh);
  sww = warp_sum(sww);
  shh = warp_sum(shh);
  const float e = swh - __ldg(a.x + b);
  if (lane == 0) a.loss[b] = e * e + a.l2 * (sww + shh);
  const float invB = 1.0f / (float)a.B;
  const float ge = invB * (2.0f * e), gr = invB * a.l2;

  // -- pass 2: gradients and the AdaGrad epilogue
  const float lr = __ldg(a.lr_eps), eps = __ldg(a.lr_eps + 1);
  for (int k = lane * W; k < d; k += step) {
    float w[W], h[W], gw[W], gh[W];
    load<W>(Wr + k, w);
    load<W>(Hr + k, h);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      gw[j] = ge * h[j] + 2.0f * (gr * w[j]);
      gh[j] = ge * w[j] + 2.0f * (gr * h[j]);
    }
    emit<W>(a.w, b, Wr, k, d, gw, lr, eps);
    emit<W>(a.h, b, Hr, k, d, gh, lr, eps);
  }
}

}  // namespace

extern "C" int adapm_mf_step(const float* w, long long w_stride, float* w_upd,
                             float* w_grad, const float* h,
                             long long h_stride, float* h_upd, float* h_grad,
                             const float* x, float* loss,
                             const float* lr_eps, int B, int d, float l2,
                             int vec, cudaStream_t stream) {
  if (B <= 0 || d <= 0) return 0;
  Args a;
  a.w = Role{w, w_stride, w_upd, w_grad};
  a.h = Role{h, h_stride, h_upd, h_grad};
  a.x = x;
  a.loss = loss;
  a.lr_eps = lr_eps;
  a.B = B;
  a.d = d;
  a.l2 = l2;
  const int grid = (B + kWarps - 1) / kWarps;
  if (vec)
    mf_step_kernel<4><<<grid, kWarps * 32, 0, stream>>>(a);
  else
    mf_step_kernel<1><<<grid, kWarps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
