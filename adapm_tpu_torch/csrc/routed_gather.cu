// K1 routed_gather: the routed fill-gather every Pull and fused-step
// read goes through.
//
// Replaces the TPU kernel adapm_tpu/ops/pallas_kernels.py gather_rows
// (a block-row gather with scalar-prefetched indices), generalized to
// the routed read the JAX package runs as an XLA program
// (device/jaxport.py _gather, ops/fused.py _read_rows):
//
//   out[i] = use_c[i] ? fill(cache)[c_sh[i], c_sl[i]] + fill(delta)[c_sh[i], c_sl[i]]
//                     : fill(main)[o_sh[i], o_sl[i]]
//
// where fill() reads 0 for any out-of-range coordinate (negative or
// past the pool; the OOB padding sentinel is 2^31-2). The choice is a
// select, never an add, so -0.0 survives a main read; cache+delta is
// one IEEE f32 add (__fadd_rn: no contraction), as in the JAX program.
// With cache == nullptr the kernel is the main-only form (the
// no-replica step variant and every plain fill-gather of a pool).
//
// A call takes an ordered list of coordinate segments (the roles of one
// pool class) and writes one [sum n, L] output, segment after segment:
// one launch per pool class per training step.
//
// Bound on an H100: bytes. Each output row reads one (or two) pool rows
// and writes one row; there is no arithmetic to speak of. The bound
// counts each distinct pool row once, so the kernel nears it only where
// a row named again is read again from L2, not from device memory.
//
// Design: each warp moves kRows = 2 rows. Its first lanes read the rows'
// coordinates and resolve their sources; the warp then issues the
// 16-byte loads of both rows' column block (4 float4 per lane, 2 KiB a
// row) before the first store, so two rows are in flight per warp, and
// stores with the streaming hint (the output is read once, by the next
// operation). Blocks of 8 warps are scheduled by the hardware: at the
// fused step's 143,360 rows of 512 f32 (chip_smoke.py phase 2, NVIDIA
// H100 80GB HBM3, 700 W) a persistent grid sized to the card, each warp
// walking 32-row windows with 4 rows in flight, took 0.2118 ms against
// index_select's 0.2018 in the same run: a warp that owns many rows
// leaves the card's tail ragged. There the batch names ~100,000
// distinct rows of 2 KiB, more than L2 holds, and the kernel runs level
// with index_select (PERF.md).
//
// Wide rows (RESCAL's relation rows of 32,768 f32, 128 KiB) are walked
// in column slabs, one per grid row: the row tile in blockIdx.x and the
// slab in blockIdx.y, so the hardware dispatches every row tile of slab
// j before slab j + 1. The wrapper (ops/kernels.py _k1_slab) makes a
// slab one column block where the rows a call can name take more than
// half of L2, else the whole row. At RESCAL's 4,096 rows naming ~1,000
// relations a slab's named rows take ~2 MB, so a relation's repeats find
// its slab in L2, and the slab form's loads ask L2 to keep their lines
// (evict_last).
// Whole rows read each repeat from device memory: a relation's 128 KiB
// has mostly left L2 before it is named again. chip_smoke.py --kernels
// K1 on the same card, device time in the trace: whole rows (the kernel
// before the slabs) 0.2862-0.2864 ms, slabs 0.2277-0.2358, index_select
// 0.2381-0.2494, against a bound of 0.1988. What is left is the device
// memory's rate on the 537 MB the call writes: fill_ of the output
// alone takes 0.1634-0.1637 ms, and K1 with every row naming one pool
// row 0.1662-0.1666; the ~130 MB of distinct rows read amid the writes
// cost the rest. At 512 f32 the batch takes whole rows (0.1949-0.1950
// ms against index_select's 0.1947-0.1948).
//
// Rows whose length is not a multiple of 4 (or unaligned pools) take the
// same kernel with 4-byte elements.
#include <cuda_runtime.h>

#include "routed_read.cuh"

namespace {

using adapm::routed_load;
using adapm::routed_source;
using adapm::routed_value;

constexpr int kMaxSeg = 8;   // segments per call (the wrapper packs more)
constexpr int kWarps = 8;    // warps per block
constexpr int kRows = 2;     // rows per warp, in flight together
constexpr int kNV = 4;       // elements per lane per column block
constexpr int kBlock = 32 * kNV;

struct Segments {
  const int* o_sh[kMaxSeg];
  const int* o_sl[kMaxSeg];
  const int* c_sh[kMaxSeg];
  const int* c_sl[kMaxSeg];
  const unsigned char* use_c[kMaxSeg];
  long long end[kMaxSeg];    // cumulative ends
  int count;
};

// kFull: the cache+delta form; kKeep: loads ask L2 to keep their lines
// (the slab form). Block (x, y) moves rows [x * kWarps * kRows, (x + 1)
// * kWarps * kRows) over columns [y * slab, (y + 1) * slab) (elements
// of T).
template <typename T, bool kFull, bool kKeep>
__global__ void __launch_bounds__(kWarps * 32) routed_gather_kernel(
    const T* __restrict__ main_pool, const T* __restrict__ cache,
    const T* __restrict__ delta, Segments segs, T* __restrict__ out,
    long long n, int shards, int slots, int c_shards, int c_slots, int W,
    int slab) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (r0 >= n) return;                        // the whole warp
  // lane g < kRows resolves row r0 + g: its source row offset (-1: a
  // zero row) and pool
  long long src = -2;                         // -2: past the batch
  bool from_c = false;
  const long long r = r0 + lane;
  if (lane < kRows && r < n) {
    int s = 0;
    long long start = 0;
    while (s + 1 < segs.count && r >= segs.end[s]) start = segs.end[s++];
    const long long k = r - start;
    src = routed_source<kFull>(segs.o_sh[s], segs.o_sl[s], segs.c_sh[s],
                               segs.c_sl[s], segs.use_c[s], k, shards,
                               slots, c_shards, c_slots, W, &from_c);
  }
  long long gsrc[kRows];
  bool gc[kRows];
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
    gsrc[g] = __shfl_sync(~0u, src, g);
    gc[g] = __shfl_sync(~0u, (int)from_c, g) != 0;
  }
  const int c_lo = (int)blockIdx.y * slab;
  const int c_hi = min(W, c_lo + slab);
  for (int cb = c_lo; cb < c_hi; cb += kBlock) {
    T va[kRows][kNV];
    T vb[kFull ? kRows : 1][kNV];
    // every load of the warp's rows first ...
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = cb + k * 32 + lane;
        if (c < c_hi)
          routed_load<T, kFull, kKeep>(main_pool, cache, delta, gsrc[g],
                                       gc[g], c, &va[g][k],
                                       &vb[kFull ? g : 0][k]);
      }
    }
    // ... then the stores
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (gsrc[g] == -2) continue;
      T* o = out + (r0 + g) * (long long)W;
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = cb + k * 32 + lane;
        if (c >= c_hi) continue;
        __stcs(o + c, routed_value<T, kFull>(va[g][k], vb[kFull ? g : 0][k],
                                             gsrc[g], gc[g]));
      }
    }
  }
}

template <typename T, bool kKeep>
void launch_kernel(const T* main_pool, const T* cache, const T* delta,
                   const Segments& segs, T* out, long long n, int shards,
                   int slots, int c_shards, int c_slots, int W, int slab,
                   dim3 grid, cudaStream_t stream) {
  if (cache != nullptr)
    routed_gather_kernel<T, true, kKeep><<<grid, kWarps * 32, 0, stream>>>(
        main_pool, cache, delta, segs, out, n, shards, slots, c_shards,
        c_slots, W, slab);
  else
    routed_gather_kernel<T, false, kKeep><<<grid, kWarps * 32, 0, stream>>>(
        main_pool, cache, delta, segs, out, n, shards, slots, c_shards,
        c_slots, W, slab);
}

// The launch over row tiles and column slabs of `slab` elements (W for
// whole rows).
template <typename T>
int launch(const T* main_pool, const T* cache, const T* delta,
           const Segments& segs, T* out, long long n, int shards, int slots,
           int c_shards, int c_slots, int W, int slab, cudaStream_t stream) {
  const long long rows_per_block = (long long)kWarps * kRows;
  const long long gx = (n + rows_per_block - 1) / rows_per_block;
  const long long gy = slab > 0 ? (W + slab - 1) / slab : 0;
  if (gy < 1 || gy > 65535 || gx > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (gy > 1)
    launch_kernel<T, true>(main_pool, cache, delta, segs, out, n, shards,
                           slots, c_shards, c_slots, W, slab, grid, stream);
  else
    launch_kernel<T, false>(main_pool, cache, delta, segs, out, n, shards,
                            slots, c_shards, c_slots, W, W, grid, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Segment s has sizes[s] rows and coordinate arrays o_sh[s], o_sl[s]
// (and c_sh[s], c_sl[s], use_c[s] when cache != nullptr); out is
// [sum sizes, L]. vec: L % 4 == 0 and every pool and out 16-byte aligned.
// slab: f32 columns a column slab (ops/kernels.py _k1_slab; L for whole
// rows, a multiple of 4 when vec).
extern "C" int adapm_routed_gather(
    const float* main_pool, const float* cache, const float* delta,
    const int* const* o_sh, const int* const* o_sl, const int* const* c_sh,
    const int* const* c_sl, const unsigned char* const* use_c,
    const long long* sizes, int nseg, float* out, int shards, int slots,
    int c_shards, int c_slots, int L, int vec, int slab,
    cudaStream_t stream) {
  if (nseg < 1 || nseg > kMaxSeg || slab < 1 || (vec && slab % 4 != 0))
    return (int)cudaErrorInvalidValue;
  Segments segs{};
  long long n = 0;
  for (int s = 0; s < nseg; ++s) {
    segs.o_sh[s] = o_sh[s];
    segs.o_sl[s] = o_sl[s];
    if (cache != nullptr) {
      segs.c_sh[s] = c_sh[s];
      segs.c_sl[s] = c_sl[s];
      segs.use_c[s] = use_c[s];
    }
    n += sizes[s];
    segs.end[s] = n;
  }
  segs.count = nseg;
  if (n <= 0) return 0;
  if (vec)
    return launch<float4>(reinterpret_cast<const float4*>(main_pool),
                          reinterpret_cast<const float4*>(cache),
                          reinterpret_cast<const float4*>(delta), segs,
                          reinterpret_cast<float4*>(out), n, shards, slots,
                          c_shards, c_slots, L / 4, slab / 4, stream);
  return launch<float>(main_pool, cache, delta, segs, out, n, shards, slots,
                       c_shards, c_slots, L, slab, stream);
}
