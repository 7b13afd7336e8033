// B2: a chain of stride-1 ResNet bottleneck blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel network_interpretation_imagenet_tpu/ops/
// pallas_bottleneck.py:105 fused_bottleneck_chain (body _chain_kernel, :60).
// Each block, with BatchNorm folded into the weights (fold_bn):
//
//   t1 = round(relu(x  @ w1 + b1))            1x1, C -> P
//   t2 = round(relu(conv3x3(t1, w3) + b3))    3x3 same padding, P -> P
//   y  = round(relu(t2 @ w2 + b2 + x))        1x1, P -> C, residual in f32
//
// with f32 accumulation and rounding to the storage type at exactly those
// three points, as bottleneck_chain_xla (:163) does. Activations are NHWC, so
// a 1x1 convolution is a plain [B*H*W, Cin] x [Cin, Cout] product and the 3x3
// one is an implicit GEMM with K = 9*Cin ordered (kh, kw, ci): the HWIO weight
// layout read as [9*Cin, Cout].
//
// What bounds it on the H100 (989 bf16 TFLOP/s, 3.35 TB/s; M = B*H*W):
// - The chain bound: 34*M*P^2 operations per block against reading x and
//   writing y once per chain. ResNet-101 at B=256: 0.23, 0.34, 2.49 and
//   0.23 ms for stages 1-4, 3.28 ms per forward.
// - The floor of three launches per block: each convolution charged
//   max(2*M*K*N / 989 TFLOP/s, (A read + output write + weights, + residual
//   for the expand) / 3.35 TB/s): 0.98, 0.82, 3.69 and 0.24 ms. Stages 1-2
//   sit on bytes (t1 and t2 go through device memory), stages 3-4 on the
//   tensor cores' rate.
//
// Design (bf16): one implicit-GEMM kernel, b2_conv_wgmma<KS, BN>, launched three
// times per block, persistent (one block per SM walks 128 x BN output tiles;
// BN = 64, 128 or 256 from the Python tile plan, ops/bottleneck_chain.py:
// conv_plan). A block has 384 threads. Warpgroup 0 is the producer: one
// thread starts TMA loads into a ring of 128B-swizzled stages (A 128 x 64,
// B 64 x BN) guarded by full/empty mbarriers, running ahead into the next
// tile while the consumers finish the last. Warpgroups 1 and 2 each run
// wgmma.mma_async m64nBNk16 on 64 rows with f32 accumulators in registers;
// setmaxnreg moves registers from the producer (40) to them (232). B, the
// weights, comes straight from JAX's [K, Cout] layout through an MN-major
// tensor map, so nothing is repacked. A of a 1x1 is a TMA box of [M, Cin].
// A of the 3x3 comes through TMA's im2col mode, one tap and one 64-channel
// slice per K step, the hardware's zero fill giving the same padding and the
// ragged last tile. (A gather by the producer warpgroup with cp.async into
// the same swizzled layout was measured too: 123 against 89 us per 3x3 at
// ResNet-101 stage 3, B=256, so im2col stayed; PERF.md.) The epilogue adds
// bias in registers, and for the expand the bf16 residual, which TMA loaded
// into the staged output tile under the main loop; it applies ReLU, rounds
// once, writes the 128B-swizzled tile to shared memory and leaves it to TMA
// stores, which overlap the next tile. This attacks the rate bound of stages
// 3-4; the byte floor of stages 1-2 stays, since t1 and t2 still go through
// device memory. The last 1x1 of every block after the first writes its
// output over its residual input in place: a tile's residual is read, by the
// same block, before the tile is written. C and P must be multiples of 64.
//
// Small batches (the BO path's B = 1 to 24) are bound by the weights' bytes
// instead: about 76 MB per ResNet-101 forward, 0.023 ms at B=1. The plan of
// whole 128 x BN tiles above gives a launch min(tiles, 132) blocks, so at B=1
// stage 3's 3x3 would run on 2 SMs, each walking all 36 K steps of a
// 128 x 256 tile. A launch whose tiles would leave SMs idle therefore takes the
// narrowest N tile whose tiles still fit, and where even 64-wide tiles leave
// SMs idle, each tile's K steps split into contiguous slices over several
// blocks (split-K; the plan is conv_plan's). A slice that is not its tile's
// last to arrive leaves its f32 partial tile in a scratch slot and counts
// itself in the tile's counter. The last adds every slice's partial in slice
// order, its own from registers, so the sum is the same bits whichever block
// arrives last; it then runs the epilogue above and zeroes the counter for
// the next launch. With slices, the residual's TMA load starts once a block
// knows it is last, so the in-place expand still reads each tile before it
// writes it. Every launch of a chain after its first starts early under the
// one before (programmatic dependent launch): its blocks set up and load
// their first weights while that one finishes, then wait for it before
// touching any activation, so this fixed cost of a launch, several
// microseconds, overlaps. (A chain's first launch waits as any kernel does:
// what ran before it on the stream may still be writing its weights.)
//
// f32 (the parity mode): the same frame on the CUDA cores; see the f32 path
// below.

#include <cuda.h>  // CUtensorMap types only; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 path

constexpr int kBM = 128, kBK = 64;  // output rows per block; K per stage (128 B)
constexpr int kTcThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kSmemMax = 232448;    // what one block may opt in to on the H100
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBox = 64 * 128;      // one staged 64 x 64 bf16 output box, 128B-swizzled

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// A wait that never ends (a lost TMA, a wrong byte count) traps after about
// 2^28 polls, seconds on the card, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (polls == (1u << 28)) __trap();
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// im2col: 128 pixels from (w, h, n) on, walking the map's bounding box in
// w, h, n order, each read at the tap offset (ow, oh); 64 channels from c.
__device__ __forceinline__ void tma_load_im2col(void* dst, const CUtensorMap* map,
                                                uint64_t* bar, int c, int w, int h, int n,
                                                int ow, int oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(static_cast<uint16_t>(ow)), "h"(static_cast<uint16_t>(oh))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {  // keep the compiler's hands off
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Split-K's handshake between the blocks of one output tile, through a
// counter in device memory: an acquire load, and an add that both releases
// this block's partial sums and acquires the others'.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ void consumers_sync() {  // the 256 threads of warpgroups 1 and 2
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// Split-K, after a split's main loop: `acc` holds its partial sums of K steps
// [k0, k1) of the tile; `slots` the tile's S = `splits` partial tiles, one per
// split, each thread's fragment as BN / 8 float4 256 apart (coalesced). A
// block that finds another split still running leaves its sums in its slot and
// returns false. The tile's last block to arrive returns true (and zeroes the
// counter for the next launch); it then takes split_sum.
template <int BN>
__device__ __forceinline__ bool split_arrive(const float (&acc)[BN / 2], float4* slots,
                                             int* counter, int split, int splits,
                                             volatile int* flag) {
  const int t = threadIdx.x - 128;
  if (t == 0) *flag = ld_acquire(counter) == splits - 1;  // every other split is in
  consumers_sync();
  bool last = *flag;
  if (!last) {
    float4* mine = slots + split * (kBM * BN / 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      __stcg(mine + j * 256 + t, make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                             acc[4 * j + 3]));
    __threadfence();
    consumers_sync();  // every thread's sums are out, and every thread has read *flag
    if (t == 0) *flag = atomic_add_acq_rel(counter, 1) == splits - 1;
    consumers_sync();
    last = *flag;
  }
  if (last && t == 0) *counter = 0;
  return last;
}

// The last block's sum over the splits, always in split order 0..S-1 with
// its own sums (still in registers) at its own index, so the f32 result is
// the same bits whichever block arrived last.
template <int BN>
__device__ __forceinline__ void split_sum(float (&acc)[BN / 2], const float4* slots, int split,
                                          int splits) {
  constexpr int kChunk = 8;  // float4 per thread in flight per split
  const int t = threadIdx.x - 128;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
    float4 sum[kChunk];
    for (int s = 0; s < splits; ++s) {
      const float4* slot = slots + s * (kBM * BN / 4) + j0 * 256 + t;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int j = j0 + q;
        const float4 v = s == split ? make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                                  acc[4 * j + 3])
                                    : __ldcg(slot + q * 256);
        if (s == 0) {
          sum[q] = v;
        } else {
          sum[q].x += v.x;
          sum[q].y += v.y;
          sum[q].z += v.z;
          sum[q].w += v.w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int j = j0 + q;
      acc[4 * j] = sum[q].x;
      acc[4 * j + 1] = sum[q].y;
      acc[4 * j + 2] = sum[q].z;
      acc[4 * j + 3] = sum[q].w;
    }
  }
}

// Programmatic dependent launch: the next launch on the stream may start
// once every block of this one has started, and runs up to its wait, which
// returns when the previous launch has finished and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_previous_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// B of one K step (rows kt * 64 .. + 63 of Wt, columns n0 .. n0 + BN - 1) into
// one ring stage: BN / 64 boxes of 64 x 64.
template <int BN>
__device__ __forceinline__ void load_b_stage(uint8_t* dst, const CUtensorMap* bmap, uint64_t* bar,
                                             int n0, int kt) {
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) tma_load_2d(dst + j * 8192, bmap, bar, n0 + 64 * j, kt * kBK);
}

// A consumer warpgroup's leader: waits until its last TMA store has read the
// staged output boxes, then, with a residual, starts its TMA loads into them
// (rows m0 .. m0 + 63, columns n0 .. n0 + BN - 1).
template <int BN>
__device__ __forceinline__ void stage_residual(uint8_t* boxes, const CUtensorMap* rmap,
                                               uint64_t* bar, int has_res, int n0, int m0) {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  if (!has_res) return;
  mbar_expect_tx(bar, (BN / 64) * kBox);
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) tma_load_2d(boxes + j * kBox, rmap, bar, n0 + 64 * j, m0);
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_m64n64k16(d, da, db, 1);
  if constexpr (BN == 128) wgmma_m64n128k16(d, da, db, 1);
  if constexpr (BN == 256) wgmma_m64n256k16(d, da, db, 1);
}

// out[m, n] = relu(sum_k A[m, k] * Wt[k, n] + bias[n] (+ residual[m, n])),
// persistent: block b computes the work items b, b + gridDim.x, ... of the
// 128 x BN output tiles (N tiles fastest, so the blocks in flight share their
// A rows in L2), each tile cut into `splits` items along K (a tile's splits
// adjacent, so they run at once). A is the NHWC input through `amap` (2D
// [M, Cin] for a 1x1, im2col of [B, H, W, Cin] for the 3x3), Wt is [K, Cout]
// through `bmap`, and the output [M, Cout] leaves through `omap` (TMA stores,
// which drop the rows past M). With `has_res`, the residual [M, Cout] comes in
// through `rmap` (TMA loads into the staged output tile, started with the
// tile, or with a split tile's fixup); it may alias the output. With
// `splits` > 1, `part` holds S partial 128 x BN f32 tiles per output tile and
// `counters` one zeroed int per tile (split_arrive).
template <int KS, int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
b2_conv_wgmma(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap rmap, const float* __restrict__ bias,
              int has_res, int H, int W, int kc, int stages, int n_tiles, int tiles,
              int splits, float* __restrict__ part, int* __restrict__ counters) {
  constexpr int B_BYTES = kBK * BN * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + stages * kABytes;
  uint8_t* staged = b_ring + stages * B_BYTES;  // [2 warpgroups][BN / 64 boxes]
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + 2 * (BN / 64) * kBox);
  uint64_t* empty = full + stages;
  uint64_t* res_full = empty + stages;  // one per consumer warpgroup
  __shared__ int last_flag[2];          // split_arrive's verdict, by item parity
  const int nk = KS * KS * kc, items = tiles * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    mbar_init(res_full, 1);
    mbar_init(res_full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  launch_dependents();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // The weights do not depend on the previous launch: the first item's
      // first stages of B start before the wait for it, A after.
      int s = 0, ph = 0, ahead = 0;
      if (blockIdx.x < items) {
        const int tile = blockIdx.x / splits, split = blockIdx.x - tile * splits;
        const int k0 = split * nk / splits;
        ahead = min(stages, (split + 1) * nk / splits - k0);
        for (int i = 0; i < ahead; ++i) {
          mbar_expect_tx(full + i, kABytes + B_BYTES);
          load_b_stage<BN>(b_ring + i * B_BYTES, &bmap, full + i, (tile % n_tiles) * BN, k0 + i);
        }
      }
      wait_previous_launch();
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item / splits, split = item - tile * splits;
        const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * kBM;
        int img = 0, p = 0, q = 0;  // the tile's first output pixel
        if constexpr (KS == 3) {
          img = m0 / (H * W);
          p = (m0 / W) % H;
          q = m0 % W;
        }
        for (int kt = split * nk / splits; kt < (split + 1) * nk / splits; ++kt) {
          if (ahead > 0) {
            --ahead;  // a fresh stage whose B is in flight
          } else {
            mbar_wait(empty + s, ph ^ 1);
            mbar_expect_tx(full + s, kABytes + B_BYTES);
            load_b_stage<BN>(b_ring + s * B_BYTES, &bmap, full + s, n0, kt);
          }
          uint8_t* a = a_ring + s * kABytes;
          if constexpr (KS == 1) {
            tma_load_2d(a, &amap, full + s, kt * kBK, m0);
          } else {
            const int tap = kt / kc;
            tma_load_im2col(a, &amap, full + s, (kt - tap * kc) * kBK, q - 1, p - 1, img,
                            tap % 3, tap / 3);
          }
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups 1 and 2: rows (wg - 1) * 64 .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    wait_previous_launch();  // before the residual, the split scratch and the output
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t a_base = smem_u32(a_ring) + wg * 64 * 128;
    const uint32_t b_base = smem_u32(b_ring);
    uint8_t* my_boxes = staged + wg * (BN / 64) * kBox;
    int s = 0, ph = 0, res_ph = 0, parity = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, parity ^= 1) {
      const int tile = item / splits, split = item - tile * splits;
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * kBM;
      // This warpgroup's staging boxes are free once its last TMA store has
      // read them; the residual then streams into them under the main loop.
      // In a split tile only the last block to arrive reads the residual and
      // writes the output, so its residual load waits for the handshake.
      if (leader && splits == 1)
        stage_residual<BN>(my_boxes, &rmap, res_full + wg, has_res, n0, m0 + wg * 64);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = split * nk / splits; kt < (split + 1) * nk / splits; ++kt) {
        mbar_wait(full + s, ph);
        acc_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: K-major rows of 128 B, 8-row groups 1024 B apart; a k16 step is 32 B.
          // B: MN-major 64-column chunks 8 KB apart (LBO), 8-k groups 1024 B apart
          // (SBO); a k16 step is 16 rows of 128 B.
          wgmma_k16<BN>(acc, sw128_desc(a_base + s * kABytes + kk * 32, 1, 64),
                        sw128_desc(b_base + s * B_BYTES + kk * 2048, 512, 64));
        }
        wgmma_commit();
        // Hand the stage back as soon as its products are done: the two
        // consumer warpgroups keep the tensor cores busy between them, and
        // the producer gets every stage but one to load ahead.
        wgmma_wait<0>();
        acc_fence(acc);
        if (lane == 0) mbar_arrive(empty + s);
        __syncwarp();
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
      if constexpr (BN == 64) {  // only 64-wide tiles split (conv_plan)
        if (splits > 1) {
          float4* slots = reinterpret_cast<float4*>(part) + tile * splits * (kBM * BN / 4);
          if (!split_arrive<BN>(acc, slots, counters + tile, split, splits, last_flag + parity))
            continue;
          if (leader)
            stage_residual<BN>(my_boxes, &rmap, res_full + wg, has_res, n0, m0 + wg * 64);
          split_sum<BN>(acc, slots, split, splits);
        }
      }

      // Epilogue, while the producer already loads the next tile. Each thread
      // reads the residual where it then writes its output.
      if (has_res) {
        mbar_wait(res_full + wg, res_ph);
        res_ph ^= 1;
      } else {
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the leader's wait
      }
      const int r0 = warp * 16 + lane / 4;  // row within this warpgroup's 64
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n0 + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
          // Box j / 8, row r, 16-byte unit (j % 8) ^ (r % 8): the 128B swizzle.
          uint8_t* dst = my_boxes + (j / 8) * kBox + r * 128 + (((j % 8) ^ (r % 8)) << 4) +
                         (lane % 4) * 4;
          if (has_res) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
            v0 += x.x;
            v1 += x.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA store
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (leader) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          asm volatile(
              "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                  "l"(reinterpret_cast<uint64_t>(&omap)),
              "r"(smem_u32(my_boxes + j * kBox)), "r"(n0 + 64 * j), "r"(m0 + wg * 64)
              : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Host side: tensor maps through the driver's entry points (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of the bf16 entry besides cudaGetLastError()'s (all negative).
constexpr int kErrDriver = -1, kErrEncode = -2, kErrPlan = -3;

void* driver_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &status);
#endif
  return err == cudaSuccess && status == cudaDriverEntryPointSuccess ? fn : nullptr;
}

// [rows, cols] bf16 row-major, read as boxes of box_rows x 64 columns (128 B).
bool map_2d(EncodeTiled enc, CUtensorMap* map, const void* base, long long rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// im2col of an NHWC [B, H, W, C] tensor for a 3x3 same-padded stride-1
// convolution: the bounding box of tap origins runs from -1 to W-2 (H-2), so
// one output pixel per position; 128 pixels x 64 channels per load.
bool map_im2col(EncodeIm2col enc, CUtensorMap* map, const void* base, int B, int H, int W,
                int C) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             lower, upper, 64, kBM, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One tile plan per convolution, as ops/bottleneck_chain.py:conv_plan gives it.
struct Plan {
  int bn, stages, smem, grid, splits;
};

// Split-K's scratch, from the wrapper: room for the partial tiles of the
// chain's largest split launch, and one zeroed counter per tile.
struct SplitScratch {
  float* part;
  int* counters;
};

template <int KS, int BN>
int launch_bn(const CUtensorMap& amap, const CUtensorMap& bmap, const CUtensorMap& omap,
              const CUtensorMap& rmap, const float* bias, int has_res, int H, int W, int Cout,
              int kc, const Plan& p, int tiles, const SplitScratch& scratch, bool pdl,
              cudaStream_t s) {
  static bool opted_in = false;  // > 48 KB of dynamic shared memory needs the opt-in
  if (!opted_in) {  // all of it but the kernel's static bytes (split-K's flags)
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, b2_conv_wgmma<KS, BN>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(b2_conv_wgmma<KS, BN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaLaunchAttribute attr;  // programmatic dependent launch (launch_dependents)
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = pdl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, b2_conv_wgmma<KS, BN>, amap, bmap, omap, rmap,
                                             bias, has_res, H, W, kc, p.stages, Cout / BN, tiles,
                                             p.splits, scratch.part, scratch.counters));
}

template <int KS>
int launch(EncodeTiled enc, const CUtensorMap& amap, const void* wt, const void* bias,
           const bf16* res, bf16* out, long long M, int H, int W, int Cin, int Cout,
           const Plan& p, const SplitScratch& sc, bool pdl, cudaStream_t s) {
  const long long need = 1024 + 256LL * p.bn + static_cast<long long>(p.stages) *
                                                   (kABytes + 128 * p.bn) + (2 * p.stages + 2) * 8;
  const long long tiles = (M + kBM - 1) / kBM * (Cout / (p.bn > 0 ? p.bn : 1));
  if ((p.bn != 64 && p.bn != 128 && p.bn != 256) || Cout % p.bn || Cin % kBK ||
      p.stages < 2 || p.smem < need || p.smem > kSmemMax || p.splits < 1 ||
      p.splits > KS * KS * (Cin / kBK) || p.grid < 1 || p.grid > tiles * p.splits ||
      (p.splits > 1 && (p.bn != 64 || sc.part == nullptr || sc.counters == nullptr)))
    return kErrPlan;
  CUtensorMap bmap, omap, rmap;
  if (!map_2d(enc, &bmap, wt, static_cast<long long>(KS) * KS * Cin, Cout, kBK) ||
      !map_2d(enc, &omap, out, M, Cout, 64) ||
      !map_2d(enc, &rmap, res != nullptr ? res : out, M, Cout, 64))
    return kErrEncode;
  const float* b = static_cast<const float*>(bias);
  const int r = res != nullptr, kc = Cin / kBK, t = static_cast<int>(tiles);
  if (p.bn == 64)
    return launch_bn<KS, 64>(amap, bmap, omap, rmap, b, r, H, W, Cout, kc, p, t, sc, pdl, s);
  if (p.bn == 128)
    return launch_bn<KS, 128>(amap, bmap, omap, rmap, b, r, H, W, Cout, kc, p, t, sc, pdl, s);
  return launch_bn<KS, 256>(amap, bmap, omap, rmap, b, r, H, W, Cout, kc, p, t, sc, pdl, s);
}

int chain_bf16(const void* x, void* out, void* t1, void* t2, const void* const* w, int n_blocks,
               int B, int H, int W, int C, int P, const int* plan, void* part, void* counters,
               void* stream) {
  static EncodeTiled tiled = nullptr;
  static EncodeIm2col im2col = nullptr;
  if (tiled == nullptr || im2col == nullptr) {
    tiled = reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
    im2col = reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
    if (tiled == nullptr || im2col == nullptr) return kErrDriver;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(B) * H * W;
  const Plan reduce{plan[0], plan[1], plan[2], plan[3], plan[4]};
  const Plan spatial{plan[5], plan[6], plan[7], plan[8], plan[9]};
  const Plan expand{plan[10], plan[11], plan[12], plan[13], plan[14]};
  const SplitScratch sc{static_cast<float*>(part), static_cast<int*>(counters)};
  const bf16* in = static_cast<const bf16*>(x);
  bf16* y = static_cast<bf16*>(out);
  bf16* a = static_cast<bf16*>(t1);
  bf16* b = static_cast<bf16*>(t2);
  for (int i = 0; i < n_blocks; ++i) {
    const void* const* wb = w + 6 * i;  // w1, b1, w3, b3, w2, b2
    CUtensorMap am;
    int rc = 0;
    if (!map_2d(tiled, &am, in, M, C, kBM)) return kErrEncode;
    rc = launch<1>(tiled, am, wb[0], wb[1], nullptr, a, M, H, W, C, P, reduce, sc, i > 0, s);
    if (rc) return rc;
    if (!map_im2col(im2col, &am, a, B, H, W, P)) return kErrEncode;
    rc = launch<3>(tiled, am, wb[2], wb[3], nullptr, b, M, H, W, P, P, spatial, sc, true, s);
    if (rc) return rc;
    if (!map_2d(tiled, &am, b, M, P, kBM)) return kErrEncode;
    rc = launch<1>(tiled, am, wb[4], wb[5], in, y, M, H, W, P, C, expand, sc, true, s);
    if (rc) return rc;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = y;
  }
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- f32 path
//
// The f32 instance (the parity mode): IEEE f32 FMAs on the CUDA cores, since
// wgmma has no true-f32 mode and TF32 stays off. b2_conv_f32<KS, BN> keeps
// the bf16 kernel's frame: persistent blocks over 128 x BN output tiles, a
// ring of TMA loads behind full/empty mbarriers (A through a 2-D map for a
// 1x1, through the im2col map for the 3x3, B through a 2-D map: no address
// arithmetic per element), split-K with the fixed-order fixup, programmatic
// dependent launch.
//
// What bounds it: operations, 2*M*K*N / 67 TFLOP/s, about 15x the bf16
// instance's bound; and right behind them shared memory, which hands an SM
// 32 four-byte values a clock, broadcasts included (a 16-byte load is four),
// against 128 FMA lanes. A thread multiplying an R x C register tile runs
// R*C / (R + C) FMAs per value it loads; at 4 the two pipes tie. (A 4 x 4
// tile with A read as scalars runs 2 and reached 0.50 of the bound on the
// H100; an 8 x 8 tile measured 0.57.) So four warps each compute 32 x BN
// outputs, a thread 8 rows x BN/8 columns: 8 x 16 (5.3 FMAs a value) for
// BN = 128, 8 x 8 (4) for BN = 64; rows ty + 4i (i = 0..7), columns 32j + 4tx
// .. + 3 (j < BN/32), lane = 8ty + tx. A K step is 32 f32 (one 128-byte row
// of a 128B-swizzled box), taken in groups of 4: a thread loads its 8 rows' 4
// k values, then for each k its columns, as 16-byte shared loads, the
// swizzle putting a quarter-warp's rows, and its column chunks, in distinct
// bank groups; 8 + 4 * BN/32 loads feed 32 * BN/8 FFMAs. The swizzled
// offsets come from 16 per-thread constants, so a load costs no integer
// instruction. Thread 0 issues the loads between its own products
// (F32Loads): a producer warp would put a third warp on a quarter of the SM,
// whose registers then cap each thread at 168, which spilled the
// accumulators. 128 threads at up to 255 registers each, two blocks an SM.

constexpr int kF32K = 32;                       // K per stage: a 128-byte row of f32
constexpr int kF32ABytes = kBM * kF32K * 4;     // one A stage, 128 x 32: 16 KB
constexpr int kF32BoxBytes = kF32K * 128;       // one 32 x 32 box of B: 4 KB
constexpr int kF32Threads = 128;                // four warps, 32 rows each

template <int BN>
struct F32Tile {
  static constexpr int kChunks = BN / 32;       // a thread's 16-byte column chunks, one a box
  static constexpr int kStage = kF32ABytes + kF32K * BN * 4;
  static constexpr int kSums = 8 * kChunks;     // a thread's sums as float4
};

// A 16-byte shared load at a shared-window address (an LDS.128: a generic
// pointer into the aligned ring would compile to a generic load).
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ float f4_at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// B of one K step (rows kt * 32 .. + 31 of Wt, columns n0 .. n0 + BN - 1) into
// one ring stage: BN / 32 boxes of 32 x 32.
template <int BN>
__device__ __forceinline__ void load_b_f32(uint8_t* dst, const CUtensorMap* bmap, uint64_t* bar,
                                           int n0, int kt) {
#pragma unroll
  for (int j = 0; j < BN / 32; ++j)
    tma_load_2d(dst + j * kF32BoxBytes, bmap, bar, n0 + 32 * j, kt * kF32K);
}

// A thread's sums acc[i][4j .. 4j + 3] as float4 number q = i * C + j.
template <int C>
__device__ __forceinline__ float4 sums_at(const float (&acc)[8][4 * C], int q) {
  const float* a = &acc[q / C][(q % C) * 4];
  return make_float4(a[0], a[1], a[2], a[3]);
}

// Split-K for the f32 tile, as split_arrive / split_sum do for bf16: each
// thread's sums leave as F32Tile::kSums float4, kF32Threads apart (coalesced).
template <int C>
__device__ __forceinline__ bool split_arrive_f32(const float (&acc)[8][4 * C], float4* slots,
                                                 int* counter, int split, int splits,
                                                 volatile int* flag) {
  const int t = threadIdx.x;
  if (t == 0) *flag = ld_acquire(counter) == splits - 1;  // every other split is in
  __syncthreads();
  bool last = *flag;
  if (!last) {
    float4* mine = slots + split * 8 * C * kF32Threads;
#pragma unroll
    for (int q = 0; q < 8 * C; ++q) __stcg(mine + q * kF32Threads + t, sums_at<C>(acc, q));
    __threadfence();
    __syncthreads();  // every thread's sums are out, and every thread has read *flag
    if (t == 0) *flag = atomic_add_acq_rel(counter, 1) == splits - 1;
    __syncthreads();
    last = *flag;
  }
  if (last && t == 0) *counter = 0;
  return last;
}

// The last block's sum over the splits in split order 0..S-1, its own sums
// (still in registers) at its own index: the same bits whichever block
// arrived last.
template <int C>
__device__ __forceinline__ void split_sum_f32(float (&acc)[8][4 * C], const float4* slots,
                                              int split, int splits) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q0 = 0; q0 < 8 * C; q0 += 4) {  // 4 float4 per thread in flight per split
    float4 sum[4];
    for (int s = 0; s < splits; ++s) {
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int q = q0 + qq;
        const float4 v = s == split ? sums_at<C>(acc, q)
                                    : __ldcg(slots + (s * 8 * C + q) * kF32Threads + t);
        if (s == 0) {
          sum[qq] = v;
        } else {
          sum[qq].x += v.x;
          sum[qq].y += v.y;
          sum[qq].z += v.z;
          sum[qq].w += v.w;
        }
      }
    }
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      float* a = &acc[(q0 + qq) / C][((q0 + qq) % C) * 4];
      a[0] = sum[qq].x;
      a[1] = sum[qq].y;
      a[2] = sum[qq].z;
      a[3] = sum[qq].w;
    }
  }
}

// The ring's loads as one stream over the block's (item, K step) pairs,
// issued by thread 0 between its own products. issue() puts the stream's next
// K step into its stage once every warp has released that stage: thread 0
// keeps the stream `stages` steps ahead of the warps, so it waits only for
// the stage all of them have just left, and the next item's first stages
// load under this item's epilogue.
template <int KS, int BN>
struct F32Loads {
  const CUtensorMap* amap;
  const CUtensorMap* bmap;
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  int H, W, kc, nk, n_tiles, splits, items, stages;
  int item, kt, k1, n0, m0, img, p, q, s, ph;

  __device__ void start_item() {
    const int tile = item / splits, split = item - tile * splits;
    kt = split * nk / splits;
    k1 = (split + 1) * nk / splits;
    n0 = (tile % n_tiles) * BN;
    m0 = (tile / n_tiles) * kBM;
    if constexpr (KS == 3) {  // the tile's first output pixel
      img = m0 / (H * W);
      p = (m0 / W) % H;
      q = m0 % W;
    }
  }
  __device__ bool more() const { return item < items; }
  __device__ void load_a_and_advance() {
    uint8_t* a = ring + s * F32Tile<BN>::kStage;
    if constexpr (KS == 1) {
      tma_load_2d(a, amap, full + s, kt * kF32K, m0);
    } else {
      const int tap = kt / kc;
      tma_load_im2col(a, amap, full + s, (kt - tap * kc) * kF32K, q - 1, p - 1, img, tap % 3,
                      tap / 3);
    }
    if (++kt == k1) {
      item += gridDim.x;
      if (item < items) start_item();
    }
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
  __device__ void issue() {
    mbar_wait(empty + s, ph ^ 1);  // a fresh barrier passes: its previous phase counts as done
    // The warps read the stage through the generic proxy and TMA overwrites
    // it through the async proxy: without this fence the load may land before
    // those reads (seen on the H100: a 16 x 32 corner of a tile wrong in 1
    // run in 5 at ResNet-101's stage 1, B=256).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(full + s, F32Tile<BN>::kStage);
    load_b_f32<BN>(ring + s * F32Tile<BN>::kStage + kF32ABytes, bmap, full + s, n0, kt);
    load_a_and_advance();
  }
};

// out[m, n] = relu(sum_k A[m, k] * Wt[k, n] + bias[n] (+ residual[m, n])) in
// f32, persistent over the tiles' `splits` K slices as b2_conv_wgmma walks
// them. A comes through `amap` (2-D [M, Cin] for a 1x1, im2col of
// [B, H, W, Cin] for the 3x3; rows past M and the 3x3's padding arrive as
// TMA's zero fill), Wt [K, Cout] through `bmap`. The epilogue reads
// `residual` (which may alias `out`: each thread reads the elements it then
// writes) and stores `out` straight from registers, rows past M masked.
template <int KS, int BN>
__global__ void __launch_bounds__(kF32Threads, 2)
b2_conv_f32(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
            const float* __restrict__ bias, const float* residual, float* out, int M, int Cout,
            int H, int W, int kc, int stages, int n_tiles, int tiles, int splits,
            float* __restrict__ part, int* __restrict__ counters) {
  using T = F32Tile<BN>;
  constexpr int C = T::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * T::kStage);
  uint64_t* empty = full + stages;
  __shared__ int last_flag[2];  // split_arrive_f32's verdict, by item parity
  const int nk = KS * KS * kc, items = tiles * splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kF32Threads / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  launch_dependents();

  F32Loads<KS, BN> loads{&amap, &bmap, ring, full, empty, H, W, kc, nk, n_tiles, splits, items,
                         stages, static_cast<int>(blockIdx.x), 0, 0, 0, 0, 0, 0, 0, 0, 0};
  int ahead = 0;
  if (threadIdx.x == 0 && loads.more()) {
    // The weights do not depend on the previous launch: the first item's
    // first stages of B start before the wait for it, A after.
    loads.start_item();
    ahead = min(stages, loads.k1 - loads.kt);
    for (int i = 0; i < ahead; ++i) {
      mbar_expect_tx(full + i, T::kStage);
      load_b_f32<BN>(ring + i * T::kStage + kF32ABytes, &bmap, full + i, loads.n0,
                     loads.kt + i);
    }
  }
  wait_previous_launch();  // before A, the residual, the split scratch and the output
  if (threadIdx.x == 0) {
    for (int i = 0; i < ahead; ++i) loads.load_a_and_advance();
    for (int i = ahead; i < stages && loads.more(); ++i) loads.issue();
  }

  // Byte offsets in a stage. Row r's logical chunk g (k = 4g .. 4g + 3) of A
  // lies at r * 128 + ((g ^ (r % 8)) << 4), and r % 8 = ty + 4 (i % 2) for
  // r = 32 warp + ty + 4i; row k's chunk tx of B's box j at kF32ABytes +
  // j * 4 KB + k * 128 + ((tx ^ (k % 8)) << 4), and k % 8 = 4 (g % 2) + kk
  // for k = 4g + kk. So xa[g ^ 4 (i % 2)] + 512 i and xb[4 (g % 2) + kk] +
  // 4096 j + 128 k hold every load's offset, the rest a compile-time constant.
  const int ty = lane / 8, tx = lane % 8;
  uint32_t xa[8], xb[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    xa[c] = (warp * 32 + ty) * 128 + ((c ^ ty) << 4);
    xb[c] = kF32ABytes + ((tx ^ c) << 4);
  }
  const uint32_t ring_u32 = smem_u32(ring);
  int s = 0, ph = 0, parity = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, parity ^= 1) {
    const int tile = item / splits, split = item - tile * splits;
    const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * kBM;
    const int r0 = m0 + warp * 32 + ty;  // this thread's rows r0 + 4i
    const int k1 = (split + 1) * nk / splits;
    float acc[8][4 * C];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4 * C; ++c) acc[i][c] = 0.f;
    for (int kt = split * nk / splits; kt < k1; ++kt) {
      mbar_wait(full + s, ph);
      const uint32_t st = ring_u32 + s * T::kStage;
#pragma unroll
      for (int g = 0; g < kF32K / 4; ++g) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = lds128(st + xa[g ^ ((i & 1) << 2)] + 512 * i);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 b[C];
#pragma unroll
          for (int j = 0; j < C; ++j)
            b[j] = lds128(st + xb[((g & 1) << 2) | kk] + kF32BoxBytes * j + 128 * (4 * g + kk));
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = f4_at(a[i], kk);
#pragma unroll
            for (int j = 0; j < C; ++j) {
              acc[i][4 * j] = fmaf(av, b[j].x, acc[i][4 * j]);
              acc[i][4 * j + 1] = fmaf(av, b[j].y, acc[i][4 * j + 1]);
              acc[i][4 * j + 2] = fmaf(av, b[j].z, acc[i][4 * j + 2]);
              acc[i][4 * j + 3] = fmaf(av, b[j].w, acc[i][4 * j + 3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // the warp has read the stage
      if (threadIdx.x == 0 && loads.more()) loads.issue();
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    if constexpr (BN == 64) {  // only 64-wide tiles split (conv_plan_f32); the 128-wide
      if (splits > 1) {        // tile's registers have no room for the fixup
        float4* slots = reinterpret_cast<float4*>(part) + tile * splits * T::kSums * kF32Threads;
        if (!split_arrive_f32<C>(acc, slots, counters + tile, split, splits, last_flag + parity))
          continue;
        split_sum_f32<C>(acc, slots, split, splits);
      }
    }

    // Epilogue: bias and residual in f32, then ReLU, stored from registers
    // while the next tile's first stages load. `residual` may alias `out`, so
    // no load may move past a store: each half of a thread's rows (i < 4, then
    // i >= 4) loads all its residual values first, one round trip to memory a
    // half. (Staging the output through the ring for TMA stores measured
    // slower: 1.62 against 1.43 ms for stage 3's 3x3s at B=256, PERF.md.)
    float4 b4[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      b4[j] = __ldg(reinterpret_cast<const float4*>(bias + n0 + 32 * j + 4 * tx));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 x[4][C];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int m = r0 + 4 * (4 * h + i);
          x[i][j] = residual != nullptr && m < M
                        ? *reinterpret_cast<const float4*>(
                              residual + static_cast<long long>(m) * Cout + n0 + 32 * j + 4 * tx)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = r0 + 4 * (4 * h + i);
        if (m >= M) continue;  // the ragged last tile
        const float* a = acc[4 * h + i];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float4 v = make_float4(a[4 * j] + b4[j].x + x[i][j].x,
                                       a[4 * j + 1] + b4[j].y + x[i][j].y,
                                       a[4 * j + 2] + b4[j].z + x[i][j].z,
                                       a[4 * j + 3] + b4[j].w + x[i][j].w);
          *reinterpret_cast<float4*>(out + static_cast<long long>(m) * Cout + n0 + 32 * j +
                                     4 * tx) =
              make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
        }
      }
    }
  }
}

// [rows, cols] f32 row-major, read as boxes of box_rows x 32 columns (128 B).
bool map_2d_f32(EncodeTiled enc, CUtensorMap* map, const void* base, long long rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {kF32K, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// im2col of an f32 NHWC [B, H, W, C] tensor, as map_im2col: 128 pixels x 32
// channels (128 B) per load.
bool map_im2col_f32(EncodeIm2col enc, CUtensorMap* map, const void* base, int B, int H, int W,
                    int C) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 4,
                                 static_cast<cuuint64_t>(W) * C * 4,
                                 static_cast<cuuint64_t>(H) * W * C * 4};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
             lower, upper, kF32K, kBM, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS, int BN>
int launch_f32_bn(const CUtensorMap& amap, const CUtensorMap& bmap, const float* bias,
                  const float* res, float* out, int M, int H, int W, int Cout, int kc,
                  const Plan& p, int tiles, const SplitScratch& scratch, bool pdl,
                  cudaStream_t s) {
  static bool opted_in = false;  // > 48 KB of dynamic shared memory needs the opt-in
  if (!opted_in) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, b2_conv_f32<KS, BN>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(b2_conv_f32<KS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax - static_cast<int>(attr.sharedSizeBytes));
    if (err == cudaSuccess)  // all of the SM's 228 KB as shared memory: two 64-wide blocks fit
      err = cudaFuncSetAttribute(b2_conv_f32<KS, BN>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaLaunchAttribute attr;  // programmatic dependent launch (launch_dependents)
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = pdl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, b2_conv_f32<KS, BN>, amap, bmap, bias, res,
                                             out, M, Cout, H, W, kc, p.stages, Cout / BN, tiles,
                                             p.splits, scratch.part, scratch.counters));
}

template <int KS>
int launch_f32(EncodeTiled enc, const CUtensorMap& amap, const void* wt, const void* bias,
               const float* res, float* out, int M, int H, int W, int Cin, int Cout,
               const Plan& p, const SplitScratch& sc, bool pdl, cudaStream_t s) {
  const long long need = 1024 + static_cast<long long>(p.stages) *
                                    (kF32ABytes + kF32K * 4 * p.bn + 16);
  const long long tiles = (static_cast<long long>(M) + kBM - 1) / kBM *
                          (Cout / (p.bn > 0 ? p.bn : 1));
  if ((p.bn != 64 && p.bn != 128) || Cout % p.bn || Cin % kF32K || p.stages < 2 ||
      p.smem < need || p.smem > kSmemMax || p.splits < 1 ||
      p.splits > KS * KS * (Cin / kF32K) || p.grid < 1 || p.grid > tiles * p.splits ||
      (p.splits > 1 && (p.bn != 64 || sc.part == nullptr || sc.counters == nullptr)))
    return kErrPlan;
  CUtensorMap bmap;
  if (!map_2d_f32(enc, &bmap, wt, static_cast<long long>(KS) * KS * Cin, Cout, kF32K))
    return kErrEncode;
  const float* b = static_cast<const float*>(bias);
  const int kc = Cin / kF32K, t = static_cast<int>(tiles);
  if (p.bn == 64)
    return launch_f32_bn<KS, 64>(amap, bmap, b, res, out, M, H, W, Cout, kc, p, t, sc, pdl, s);
  return launch_f32_bn<KS, 128>(amap, bmap, b, res, out, M, H, W, Cout, kc, p, t, sc, pdl, s);
}

int chain_f32(const void* x, void* out, void* t1, void* t2, const void* const* w, int n_blocks,
              int B, int H, int W, int C, int P, const int* plan, void* part, void* counters,
              void* stream) {
  static EncodeTiled tiled = nullptr;
  static EncodeIm2col im2col = nullptr;
  if (tiled == nullptr || im2col == nullptr) {
    tiled = reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
    im2col = reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
    if (tiled == nullptr || im2col == nullptr) return kErrDriver;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;  // below 2^31: the wrapper checks
  const Plan reduce{plan[0], plan[1], plan[2], plan[3], plan[4]};
  const Plan spatial{plan[5], plan[6], plan[7], plan[8], plan[9]};
  const Plan expand{plan[10], plan[11], plan[12], plan[13], plan[14]};
  const SplitScratch sc{static_cast<float*>(part), static_cast<int*>(counters)};
  const float* in = static_cast<const float*>(x);
  float* y = static_cast<float*>(out);
  float* a = static_cast<float*>(t1);
  float* b = static_cast<float*>(t2);
  for (int i = 0; i < n_blocks; ++i) {
    const void* const* wb = w + 6 * i;  // w1, b1, w3, b3, w2, b2
    CUtensorMap am;
    int rc = 0;
    if (!map_2d_f32(tiled, &am, in, M, C, kBM)) return kErrEncode;
    rc = launch_f32<1>(tiled, am, wb[0], wb[1], nullptr, a, M, H, W, C, P, reduce, sc, i > 0, s);
    if (rc) return rc;
    if (!map_im2col_f32(im2col, &am, a, B, H, W, P)) return kErrEncode;
    rc = launch_f32<3>(tiled, am, wb[2], wb[3], nullptr, b, M, H, W, P, P, spatial, sc, true, s);
    if (rc) return rc;
    if (!map_2d_f32(tiled, &am, b, M, P, kBM)) return kErrEncode;
    rc = launch_f32<1>(tiled, am, wb[4], wb[5], in, y, M, H, W, P, C, expand, sc, true, s);
    if (rc) return rc;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = y;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entries: x, out: [B, H, W, C] NHWC in the entry's type; t1, t2:
// [B, H, W, P] scratch; w: host array of 6*n_blocks device pointers per block
// (w1 [C, P], b1 f32 [P], w3 [3, 3, P, P], b3 f32 [P], w2 [P, C], b2 f32 [C]);
// plan: 15 host ints, (N tile, stages, dynamic shared-memory bytes, grid, K
// splits) for the reduce, 3x3 and expand convolutions (ops/bottleneck_chain.py:
// conv_plan for bf16, conv_plan_f32 for f32); part: f32 scratch for the
// partial tiles of the largest split launch, counters: one zeroed int32 per
// tile of it (both may be null when no launch splits K). C and P are
// multiples of 64. Returns cudaGetLastError(), or -1 (no driver entry point
// for tensor maps), -2 (a tensor map was refused) or -3 (a plan the kernel
// cannot run).
int bottleneck_chain_bf16(const void* x, void* out, void* t1, void* t2, const void* const* w,
                          int n_blocks, int B, int H, int W, int C, int P, const int* plan,
                          void* part, void* counters, void* stream) {
  return chain_bf16(x, out, t1, t2, w, n_blocks, B, H, W, C, P, plan, part, counters, stream);
}

int bottleneck_chain_f32(const void* x, void* out, void* t1, void* t2, const void* const* w,
                         int n_blocks, int B, int H, int W, int C, int P, const int* plan,
                         void* part, void* counters, void* stream) {
  return chain_f32(x, out, t1, t2, w, n_blocks, B, H, W, C, P, plan, part, counters, stream);
}

}  // extern "C"
