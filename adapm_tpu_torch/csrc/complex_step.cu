// K5 complex_step: the ComplEx training step's model math in one launch:
// the loss, its gradient for every role, and the AdaGrad update rows.
//
// Replaces the model math of the JAX package's fused step
// (adapm_tpu/ops/fused.py _build_device_routed_body: value_and_grad of
// models/kge.py make_kge_loss("complex", T, l2), then
// upd = [-lr*g*rsqrt(acc + g^2 + eps) | g^2]), which XLA compiles into
// the step's one program, and on this path the TPU kernel
// adapm_tpu/ops/pallas_kernels.py adagrad_apply: its arithmetic is this
// kernel's epilogue (adagrad.cuh, shared with K2 instruction for
// instruction).
//
// Per triple b, with pos = score(s, r, o), ns_n = score(neg_n, r, o) and
// no_n = score(s, r, neg_n):
//
//   loss_b = softplus(-pos) + sum_n w^s_n softplus(ns_n)
//          + sum_n w^o_n softplus(no_n) [+ l2 (|s|^2 + |r|^2 + |o|^2)]
//
// with w = 1, or softmax(T * score) over n (a stopped gradient) when
// T > 0. The score is linear in each argument, so with
// dpos = -sig(-pos)/B, dns_n = w^s_n sig(ns_n)/B, dno_n = w^o_n sig(no_n)/B,
// NS = sum_n dns_n neg_n and NO = sum_n dno_n neg_n:
//
//   g_s = d_s(r, dpos o + NO)          g_o = d_o(dpos s + NS, r)
//   g_r = d_r(dpos s + NS, o) + d_r(s, NO)
//   g_neg_n = dns_n d_s(r, o) + dno_n d_o(s, r)      (+ 2 l2 x / B on s, r, o)
//
// where d_s(r, o) = (rr or + ri oi, rr oi - ri or), d_o(s, r) =
// (sr rr - si ri, si rr + sr ri) and d_r(s, o) = (sr or + si oi,
// sr oi - si or) for [re | im] halves. A duplicated key gets one update
// row per occurrence; K3 folds them in batch order.
//
// Bound on an H100: bytes. Each gathered row ([emb 2d | acc 2d] f32) is
// read once and one update row ([upd 2d | g^2 2d]) written per row; the
// arithmetic is a few hundred flops per row. Design (a first version:
// right and simple): one CTA of 128 threads per triple. Its 3 + N rows
// are copied whole into shared memory with cp.async (16-byte copies when
// d % 4 == 0 and the rows are aligned), so every load of the triple is
// in flight at once. Pass 1 forms d_s(r, o) and d_o(s, r) per
// coordinate, then the 2N + 1 dots (and the three squared norms when
// l2 > 0), one warp per dot, reduced by a fixed shuffle butterfly; one
// warp then computes the weights, sigmoids and the loss. Pass 2 needs no
// reduction: per coordinate NS and NO (a loop over n in order), the
// gradients and the epilogue on the staged accumulators. No atomics, so
// two runs are bitwise equal. Frozen roles (a null update pointer) are
// read and never written. Shared memory is ((3 + N) 4d + 4d + 4N + 5)
// floats, 74,260 bytes at d = 128, N = 32: three CTAs per SM.
#include <cuda_runtime.h>

#include "adagrad.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Role {
  const float* rows;  // gathered rows [emb 2d | acc 2d]
  long long stride;   // floats between consecutive rows
  float* upd;         // [n, 4d] update rows, or null (frozen role)
  float* grad;        // [n, 2d] gradient rows, or null
};

struct Args {
  Role s, r, o, neg;  // neg row (b, n) is row b*N + n
  float* loss;        // [B] per-triple loss
  const float* lr_eps;
  int B, N, d;
  float temp, l2;
};

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

// The gradient of W consecutive coordinates k..k+W-1 of one row (re at k,
// im at d + k): optional gradient output, then the AdaGrad epilogue on
// the row's staged accumulator half into its update row.
template <int W>
__device__ __forceinline__ void emit(const Role& role, long long row,
                                     const float* acc, int k, int d,
                                     const float (&gre)[W],
                                     const float (&gim)[W], float lr,
                                     float eps) {
  const int D = 2 * d;
  if (role.grad != nullptr) {
    float* g = role.grad + row * D;
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(g + k) =
          make_float4(gre[0], gre[1], gre[2], gre[3]);
      *reinterpret_cast<float4*>(g + d + k) =
          make_float4(gim[0], gim[1], gim[2], gim[3]);
    } else {
      g[k] = gre[0];
      g[d + k] = gim[0];
    }
  }
  if (role.upd == nullptr) return;
  float ure[W], uim[W], qre[W], qim[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    adapm::upd_one(gre[j], acc[k + j], lr, eps, &ure[j], &qre[j]);
    adapm::upd_one(gim[j], acc[d + k + j], lr, eps, &uim[j], &qim[j]);
  }
  float* u = role.upd + row * 2 * D;
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(u + k) =
        make_float4(ure[0], ure[1], ure[2], ure[3]);
    *reinterpret_cast<float4*>(u + d + k) =
        make_float4(uim[0], uim[1], uim[2], uim[3]);
    *reinterpret_cast<float4*>(u + D + k) =
        make_float4(qre[0], qre[1], qre[2], qre[3]);
    *reinterpret_cast<float4*>(u + D + d + k) =
        make_float4(qim[0], qim[1], qim[2], qim[3]);
  } else {
    u[k] = ure[0];
    u[d + k] = uim[0];
    u[D + k] = qre[0];
    u[D + d + k] = qim[0];
  }
}

// W = 4: 16-byte copies and stores (d % 4 == 0, every row 16-byte
// aligned); W = 1: 4-byte elements.
template <int W>
__global__ void __launch_bounds__(kThreads)
    complex_step_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, d = a.d, D = 2 * d, L = 4 * d;
  const int nrows = 3 + N;
  float* rows = sm;                          // [3 + N][4d]: s, r, o, neg
  float* As = rows + (long long)nrows * L;   // d_s(r, o)   [2d]
  float* Ao = As + D;                        // d_o(s, r)   [2d]
  float* dots = Ao + D;    // ns[N], no[N], pos, |s|^2, |r|^2, |o|^2
  float* coef = dots + 2 * N + 4;            // dns[N], dno[N], dpos

  // -- stage the triple's rows
  {
    const int per = L / W;
    for (int i = tid; i < nrows * per; i += kThreads) {
      const int row = i / per, c = (i - row * per) * W;
      const float* src;
      if (row == 0) src = a.s.rows + b * a.s.stride;
      else if (row == 1) src = a.r.rows + b * a.r.stride;
      else if (row == 2) src = a.o.rows + b * a.o.stride;
      else src = a.neg.rows + ((long long)b * N + (row - 3)) * a.neg.stride;
      if constexpr (W == 4) cp_async16(rows + row * L + c, src + c);
      else cp_async4(rows + row * L + c, src + c);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const float* S = rows;
  const float* R = rows + L;
  const float* O = rows + 2 * L;
  const float* NEG = rows + 3 * L;

  // -- pass 1: the partial derivatives, then the dots
  for (int k = tid; k < d; k += kThreads) {
    const float sr = S[k], si = S[d + k], rr = R[k], ri = R[d + k];
    const float orr = O[k], oi = O[d + k];
    As[k] = rr * orr + ri * oi;
    As[d + k] = rr * oi - ri * orr;
    Ao[k] = sr * rr - si * ri;
    Ao[d + k] = si * rr + sr * ri;
  }
  __syncthreads();
  const int ndots = 2 * N + 1 + (a.l2 > 0.0f ? 3 : 0);
  for (int j = warp; j < ndots; j += kWarps) {
    const float *x, *y;
    if (j < N) { x = NEG + j * L; y = As; }
    else if (j < 2 * N) { x = NEG + (j - N) * L; y = Ao; }
    else if (j == 2 * N) { x = S; y = As; }
    else { x = rows + (j - 2 * N - 1) * L; y = x; }
    float acc = 0.0f;
    for (int k = lane; k < D; k += 32) acc += x[k] * y[k];
    acc = warp_sum(acc);
    if (lane == 0) dots[j] = acc;
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
        for (int n = lane; n < N; n += 32) mx = fmaxf(mx, a.temp * sc[n]);
        mx = warp_max(mx);
        for (int n = lane; n < N; n += 32) z += expf(a.temp * sc[n] - mx);
        z = warp_sum(z);
      }
      for (int n = lane; n < N; n += 32) {
        const float x = sc[n];
        const float w = a.temp > 0.0f ? expf(a.temp * x - mx) / z : 1.0f;
        lsum += w * softplus(x);
        coef[side * N + n] = w * sigmoid(x) * invB;
      }
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      const float pos = dots[2 * N];
      float l = softplus(-pos) + lsum;
      if (a.l2 > 0.0f)
        l += a.l2 * (dots[2 * N + 1] + dots[2 * N + 2] + dots[2 * N + 3]);
      a.loss[b] = l;
      coef[2 * N] = -sigmoid(-pos) * invB;
    }
  }
  __syncthreads();

  // -- pass 2: gradients and the AdaGrad epilogue
  const float lr = __ldg(a.lr_eps), eps = __ldg(a.lr_eps + 1);
  const float dpos = coef[2 * N];
  const float c2 = a.l2 > 0.0f ? 2.0f * a.l2 / (float)a.B : 0.0f;
  for (int k = tid * W; k < d; k += kThreads * W) {
    float gs_re[W], gs_im[W], go_re[W], go_im[W], gr_re[W], gr_im[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int kk = k + j;
      float nsr = 0.0f, nsi = 0.0f, nor = 0.0f, noi = 0.0f;
      for (int n = 0; n < N; ++n) {
        const float xr = NEG[n * L + kk], xi = NEG[n * L + d + kk];
        const float cs = coef[n], co = coef[N + n];
        nsr += cs * xr;
        nsi += cs * xi;
        nor += co * xr;
        noi += co * xi;
      }
      const float sr = S[kk], si = S[d + kk], rr = R[kk], ri = R[d + kk];
      const float orr = O[kk], oi = O[d + kk];
      const float xr = dpos * orr + nor, xi = dpos * oi + noi;  // dpos o + NO
      const float yr = dpos * sr + nsr, yi = dpos * si + nsi;   // dpos s + NS
      gs_re[j] = rr * xr + ri * xi + c2 * sr;
      gs_im[j] = rr * xi - ri * xr + c2 * si;
      go_re[j] = yr * rr - yi * ri + c2 * orr;
      go_im[j] = yi * rr + yr * ri + c2 * oi;
      gr_re[j] = (yr * orr + yi * oi) + (sr * nor + si * noi) + c2 * rr;
      gr_im[j] = (yr * oi - yi * orr) + (sr * noi - si * nor) + c2 * ri;
    }
    emit<W>(a.s, b, S + D, k, d, gs_re, gs_im, lr, eps);
    emit<W>(a.r, b, R + D, k, d, gr_re, gr_im, lr, eps);
    emit<W>(a.o, b, O + D, k, d, go_re, go_im, lr, eps);
  }
  const int per = d / W;
  for (int i = tid; i < N * per; i += kThreads) {
    const int n = i / per, k = (i - n * per) * W;
    const float cs = coef[n], co = coef[N + n];
    float g_re[W], g_im[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      g_re[j] = cs * As[k + j] + co * Ao[k + j];
      g_im[j] = cs * As[d + k + j] + co * Ao[d + k + j];
    }
    emit<W>(a.neg, (long long)b * N + n, NEG + n * L + D, k, d, g_re, g_im,
            lr, eps);
  }
}

template <int W>
int launch(const Args& a, int smem, cudaStream_t stream) {
  // raise the kernel's dynamic shared memory cap once per size, outside
  // any stream capture (the first launch of a shape runs eagerly)
  static int cap = 48 * 1024;
  if (smem > cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        complex_step_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  complex_step_kernel<W><<<a.B, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes of one CTA at (N, d).
extern "C" long long adapm_complex_step_smem(int N, int d) {
  return ((3LL + N) * 4 * d + 4LL * d + 4LL * N + 5) * 4;
}

extern "C" int adapm_complex_step(
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
  const int smem = (int)adapm_complex_step_smem(N, d);
  return vec ? launch<4>(a, smem, stream) : launch<1>(a, smem, stream);
}
