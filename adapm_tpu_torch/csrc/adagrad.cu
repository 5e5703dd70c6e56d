// K2 adagrad_update: the AdaGrad row transform of the fused step.
//
// Replaces the TPU kernel adapm_tpu/ops/pallas_kernels.py adagrad_apply
// (a 256-row VMEM-blocked elementwise pass) and the transform the JAX
// fused step leaves to XLA (ops/fused.py, _build_device_routed_body):
//
//   fused form      upd[i] = [ -lr*g*rsqrt(acc + g*g + eps) | g*g ]
//   standalone form acc' = acc + g*g;  emb' = emb - lr*g*rsqrt(acc' + eps)
//
// The fused form reads lr and eps from a 2-float device array when it is
// given one (the fused step's, which a captured CUDA graph follows from
// replay to replay, as K5 reads it), else takes them as arguments.
//
// Every operation is an explicitly rounded intrinsic in the order the
// plain PyTorch version evaluates it, so nvcc cannot contract a
// multiply-add into an FMA; rsqrt is 1/sqrt with both steps correctly
// rounded (the CPU's torch.rsqrt arithmetic). The fused form's
// arithmetic lives in adagrad.cuh, which K5 (complex_step.cu) shares as
// its epilogue. The JAX package's lax.rsqrt may differ in the last bit,
// which the model-math tolerance covers.
//
// Bound on an H100: bytes (a handful of flops per 12-16 bytes moved).
// Design: a grid-stride loop over 4-wide vectors; the accumulator is
// read in place from the gathered [emb | acc] rows through a row
// stride, so no copy of it is made.
#include <cuda_runtime.h>

#include "adagrad.cuh"

namespace {

using adapm::rsqrt_rn;
using adapm::upd_one;

// n rows of D; g is [n, D] contiguous, acc rows start acc_stride floats
// apart, upd is [n, 2D] contiguous. kVec: D and acc_stride are
// multiples of 4 and every base pointer is 16-byte aligned. lr_eps, when
// not null, holds (lr, eps) and overrides the two scalars.
template <bool kVec>
__global__ void adagrad_update_kernel(const float* __restrict__ g,
                                      const float* __restrict__ acc,
                                      long long acc_stride,
                                      float* __restrict__ upd, long long n,
                                      int D, const float* __restrict__ lr_eps,
                                      float lr, float eps) {
  if (lr_eps != nullptr) {
    lr = __ldg(lr_eps);
    eps = __ldg(lr_eps + 1);
  }
  const int W = kVec ? 4 : 1;
  const int per_row = D / W;
  const long long total = n * per_row;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long i = t / per_row;
    const int j = (int)(t - i * per_row) * W;
    const float* gp = g + i * D + j;
    const float* ap = acc + i * acc_stride + j;
    float* up = upd + i * 2LL * D + j;
    if (kVec) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gp));
      const float4 av = __ldg(reinterpret_cast<const float4*>(ap));
      float4 u, q;
      upd_one(gv.x, av.x, lr, eps, &u.x, &q.x);
      upd_one(gv.y, av.y, lr, eps, &u.y, &q.y);
      upd_one(gv.z, av.z, lr, eps, &u.z, &q.z);
      upd_one(gv.w, av.w, lr, eps, &u.w, &q.w);
      *reinterpret_cast<float4*>(up) = u;
      *reinterpret_cast<float4*>(up + D) = q;
    } else {
      upd_one(__ldg(gp), __ldg(ap), lr, eps, up, up + D);
    }
  }
}

__global__ void adagrad_apply_kernel(const float* __restrict__ g,
                                     const float* __restrict__ emb,
                                     const float* __restrict__ acc,
                                     float* __restrict__ emb_out,
                                     float* __restrict__ acc_out,
                                     long long total, float lr, float eps) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const float gv = __ldg(g + t);
    const float a2 = __fadd_rn(__ldg(acc + t), __fmul_rn(gv, gv));
    acc_out[t] = a2;
    const float step = __fmul_rn(__fmul_rn(lr, gv),
                                 rsqrt_rn(__fadd_rn(a2, eps)));
    emb_out[t] = __fsub_rn(__ldg(emb + t), step);
  }
}

int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 32;  // enough blocks to fill every SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" int adapm_adagrad_update(const float* g, const float* acc,
                                    long long acc_stride, float* upd,
                                    long long n, int D, const float* lr_eps,
                                    float lr, float eps, int vec,
                                    cudaStream_t stream) {
  if (n <= 0 || D <= 0) return 0;
  const int threads = 256;
  if (vec)
    adagrad_update_kernel<true>
        <<<grid_for(n * (D / 4), threads), threads, 0, stream>>>(
            g, acc, acc_stride, upd, n, D, lr_eps, lr, eps);
  else
    adagrad_update_kernel<false>
        <<<grid_for(n * D, threads), threads, 0, stream>>>(
            g, acc, acc_stride, upd, n, D, lr_eps, lr, eps);
  return (int)cudaGetLastError();
}

extern "C" int adapm_adagrad_apply(const float* g, const float* emb,
                                   const float* acc, float* emb_out,
                                   float* acc_out, long long total, float lr,
                                   float eps, cudaStream_t stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  adagrad_apply_kernel<<<grid_for(total, threads), threads, 0, stream>>>(
      g, emb, acc, emb_out, acc_out, total, lr, eps);
  return (int)cudaGetLastError();
}
