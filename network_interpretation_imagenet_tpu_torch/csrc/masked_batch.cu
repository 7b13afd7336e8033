// B1: fused window-mask build + image masking + cast, for Hopper (sm_90a).
//
// Replaces the TPU kernel network_interpretation_imagenet_tpu/ops/
// pallas_masking.py:49 masked_batch_pallas (body _mask_apply_kernel, :34).
//
//   out[k, h, w, c] = cast(image[h, w, c] * [firsts[k] <= seg[h, w] < firsts[k] + width])
//
// The width is a kernel argument, or, where `width_dev` is not null, the int32
// it points to on the device: a captured CUDA graph then serves every width.
//
// Windows that run past the last segment clip, as the comparison does by
// itself. The product is taken in f32 and rounded once (round to nearest
// even), so the result is bit-identical to window_masks + apply_masks + cast.
//
// What bounds it on the H100: bytes, and almost all of them are the output.
// At K=256 masks of a 224x224x3 image in bf16 the call must write 77.1 MB
// and read 0.8 MB (image f32, segment ids, starts): 0.0232 ms at 3.35 TB/s.
// So every output byte should leave in a 16-byte store, a warp's 32 stores
// 512 contiguous bytes.
//
// Why rows lose alignment: row k of the output starts k*H*W*C elements past
// `out`. Where H*W*C is not a multiple of the 16-byte word (8 bf16, 4 f32
// elements; Inception-v3's 299x299x3 = 268,203 is odd), consecutive rows
// start at every residue mod 16 bytes in turn (8 residues in bf16, 4 in
// f32). An `out=` slice of a batch buffer (one image's masks of a
// multi-image chunk) starts wherever its first mask falls, so even its first
// row can be off alignment. The design keys on each row's real address.
//
// Design: the grid is (ceil(H*W*C / 8 / 256), ceil(K / group)), the group
// from the Python wrapper (ops/masked_batch.py:launch_plan), so a block
// writes tens of KB. A block reads its masks' starts into shared memory once.
// Each warp owns 256 elements of every row of its block, as 8 (bf16) or 4
// (f32) elements to a 16-byte word and one word (two) to a lane: lane l's
// word q starts at element warp_start + q*128 + l*4 (f32) or warp_start +
// l*8 (bf16), so each store instruction of a warp covers 512 contiguous
// bytes. In a row whose first 16-byte boundary lies `shift` elements in
// (shift = 0..7 in bf16, 0..3 in f32), every word moves `shift` elements up
// and lands on a 16-byte boundary: one 16-byte store each. The row's head
// [0, shift) is written by thread 0, and a word that runs past the row's
// end by its thread, with scalar stores, and only they are. A thread loads
// its image values and segment ids once per block, for each word a window
// of 8 + 7 (bf16) or 4 + 3 (f32) elements in registers. Row k's residue is
// (out/sizeof + k*H*W*C) mod the word, so it repeats with a period of at
// most 8 rows (the wrapper passes it): the thread walks its block's rows by
// residue class, and for each class a switch enters a copy of the row loop
// compiled for that shift, so the windows are indexed at compile time and
// stay in registers.
// That was chosen over staging the image in shared memory, which reads 16
// values from shared memory per mask and thread and conflicts in banks at a
// thread stride of 8 words, while the class walk costs nothing per mask.
// Where every row is aligned (out on a 16-byte boundary and H*W*C a
// multiple of the word, as 224x224x3 is), the wrapper (ops/masked_batch.py:
// row_plan) says so and the launch takes an instance that loads only a
// word's own values and runs the one row loop at shift 0. In
// bf16 that is the design that held before rows were taken apart by
// residue; in f32 a lane's two words now lie 512 bytes apart, where before
// they lay side by side and each store instruction of a warp wrote every
// other 16 bytes of 1,024, which halved the aligned f32 time on the H100
// (224x224x3, K=256: 0.105 -> 0.052-0.056 ms; PERF.md). The image is
// read with 16-byte loads where it is 16-byte aligned (one image of a
// stacked batch at 299x299x3 is not), else with scalar loads. C is a
// compile-time constant for RGB (C=3), so no integer division is left per
// element; other C take a generic instance. ops/masked_batch.py:row_shift,
// residue_classes and thread_stores model the split, and the CPU tests
// check that it writes each element exactly once; `launch` refuses an
// `aligned` or `period` that the rows do not have.
// Left for later: fusing the build into the stem convolution's input load,
// which would remove the output's round trip through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kMaxGroup = 64;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// The rows first, first + step, ... < nk of the block (row 0 at out_k0),
// all with their first 16-byte boundary `Shift` elements in. Word q of this
// thread holds the row elements [i0 + q * 32 * kV + Shift, ... + kV): lane
// l's word is the l-th of its warp's 32 in a row of words, so each store
// instruction of a warp covers 512 contiguous bytes. x[q] and s[q] hold the
// image values and segment ids from i0 + q * 32 * kV on. Thread 0 also
// writes the head [0, Shift).
template <typename T, int Shift, int kWords, int kLoadW, int kWinW>
__device__ __forceinline__ void rows(const float (&x)[kWords][kLoadW],
                                     const int (&s)[kWords][kWinW], const int* lo_s, int first,
                                     int step, int nk, T* out_k0, int hwc, int i0, int wd) {
  constexpr int kV = 16 / sizeof(T);
  static_assert(kWords * kV == kPerThread, "a thread owns kPerThread elements");
  static_assert(Shift + kV <= kWinW && kWinW <= kLoadW, "window too short for the shift");
  bool whole[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) whole[q] = i0 + q * 32 * kV + Shift + kV <= hwc;
  const bool head = Shift > 0 && i0 == 0;
  const long long stride = static_cast<long long>(step) * hwc;
  T* dst = out_k0 + static_cast<long long>(first) * hwc + i0 + Shift;
  for (int k = first; k < nk; k += step, dst += stride) {
    const int lo = lo_s[k], hi = lo + wd;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      alignas(16) T v[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j)
        v[j] = from_float<T>(x[q][Shift + j] *
                             ((s[q][Shift + j] >= lo && s[q][Shift + j] < hi) ? 1.f : 0.f));
      T* d = dst + q * 32 * kV;
      if (whole[q]) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j)
          if (i0 + q * 32 * kV + Shift + j < hwc) d[j] = v[j];
      }
    }
    if (head) {
#pragma unroll
      for (int j = 0; j < Shift; ++j)
        if (j < hwc)
          (dst - Shift)[j] =
              from_float<T>(x[0][j] * ((s[0][j] >= lo && s[0][j] < hi) ? 1.f : 0.f));
    }
  }
}

// CC > 0: the channel count at compile time; CC == 0: `c` at run time.
// kAligned: every row starts on a 16-byte boundary (shift 0 throughout).
template <typename T, int CC, bool kAligned>
__global__ void __launch_bounds__(kThreads)
b1_masked_batch(const float* __restrict__ image, const int* __restrict__ seg,
                const int* __restrict__ firsts, int width, const int* __restrict__ width_dev,
                T* __restrict__ out, int hwc, int c, int k_total, int group, int period) {
  constexpr int kV = 16 / sizeof(T);               // elements per 16-byte word
  constexpr int kWords = kPerThread / kV;          // a thread's words in a row: 1 bf16, 2 f32
  constexpr int kWinW = kAligned ? kV : 2 * kV - 1;  // elements a word may read at any shift
  constexpr int kLoadW = (kWinW + 3) / 4 * 4;      // whole float4s
  __shared__ int lo_s[kMaxGroup];
  const int k0 = blockIdx.y * group;
  const int nk = min(group, k_total - k0);
  if (threadIdx.x < nk) lo_s[threadIdx.x] = __ldg(firsts + k0 + threadIdx.x);
  __syncthreads();

  // The warp's 256 elements, then this lane's first word in them.
  const int i0 = (blockIdx.x * kThreads + (threadIdx.x & ~31)) * kPerThread +
                 (threadIdx.x & 31) * kV;
  if (i0 >= hwc) return;
  const int cc = CC > 0 ? CC : c;
  const int wd = width_dev != nullptr ? __ldg(width_dev) : width;
  const bool image_vec = (reinterpret_cast<uintptr_t>(image) & 15) == 0;
  float x[kWords][kLoadW];
  int s[kWords][kWinW];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int e = i0 + q * 32 * kV;
    if (image_vec && e + kLoadW <= hwc) {
      const float4* src = reinterpret_cast<const float4*>(image + e);
#pragma unroll
      for (int u = 0; u < kLoadW / 4; ++u) {
        const float4 a = __ldg(src + u);
        x[q][4 * u] = a.x, x[q][4 * u + 1] = a.y, x[q][4 * u + 2] = a.z, x[q][4 * u + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLoadW; ++j) x[q][j] = __ldg(image + min(e + j, hwc - 1));
    }
#pragma unroll
    for (int j = 0; j < kWinW; ++j) s[q][j] = __ldg(seg + min(e + j, hwc - 1) / cc);
  }

  T* out_k0 = out + static_cast<long long>(k0) * hwc;
  if constexpr (kAligned) {
    rows<T, 0>(x, s, lo_s, 0, 1, nk, out_k0, hwc, i0, wd);
  } else {
    // Rows `period` apart share a residue: hwc * period is a whole number of words.
    const unsigned long long base = reinterpret_cast<uintptr_t>(out) / sizeof(T);
    for (int q = 0; q < min(period, nk); ++q) {
      const int r = static_cast<int>((base + static_cast<unsigned long long>(k0 + q) * hwc) % kV);
      switch ((kV - r) % kV) {
        case 0: rows<T, 0>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
        case 1: rows<T, 1>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
        case 2: rows<T, 2>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
        case 3: rows<T, 3>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
        default:
          if constexpr (kV == 8) {
            switch ((kV - r) % kV) {
              case 4: rows<T, 4>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
              case 5: rows<T, 5>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
              case 6: rows<T, 6>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
              default: rows<T, 7>(x, s, lo_s, q, period, nk, out_k0, hwc, i0, wd); break;
            }
          }
      }
    }
  }
}

template <typename T, int CC>
void launch_instance(bool aligned, dim3 grid, cudaStream_t s, const float* im, const int* sg,
                     const int* fs, int width, const int* wd, T* o, int hwc, int c, int k,
                     int group, int period) {
  if (aligned)
    b1_masked_batch<T, CC, true><<<grid, kThreads, 0, s>>>(im, sg, fs, width, wd, o, hwc, c, k,
                                                           group, period);
  else
    b1_masked_batch<T, CC, false><<<grid, kThreads, 0, s>>>(im, sg, fs, width, wd, o, hwc, c, k,
                                                            group, period);
}

template <typename T>
int launch(const void* image, const void* seg, const void* firsts, int width,
           const void* width_dev, void* out, int k, int hwc, int c, int group, int grid_x,
           int grid_y, int aligned, int period, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  if (group < 1 || group > kMaxGroup || grid_y != (k + group - 1) / group ||
      grid_x != (hwc + kPerThread * kThreads - 1) / (kPerThread * kThreads) ||
      reinterpret_cast<uintptr_t>(out) % sizeof(T) != 0 || period < 1 || period > kV ||
      period * (hwc % kV) % kV != 0 ||
      (aligned && ((reinterpret_cast<uintptr_t>(out) & 15) != 0 || hwc % kV != 0)))
    return -3;  // a plan the kernel cannot run
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(image);
  const int* sg = static_cast<const int*>(seg);
  const int* fs = static_cast<const int*>(firsts);
  const int* wd = static_cast<const int*>(width_dev);
  T* o = static_cast<T*>(out);
  if (c == 3)
    launch_instance<T, 3>(aligned, grid, s, im, sg, fs, width, wd, o, hwc, c, k, group, period);
  else
    launch_instance<T, 0>(aligned, grid, s, im, sg, fs, width, wd, o, hwc, c, k, group, period);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// image f32[H*W*C], seg i32[H*W], firsts i32[K] (all on the device), width
// or (when not null) width_dev i32[1] on the device -> out[K*H*W*C], at any
// element-aligned address; masks go in groups of `group` (at most 64) per
// block row of the (grid_x, grid_y) grid. `aligned` (every row on a 16-byte
// boundary) picks the instance at shift 0; rows `period` apart share their
// residue. The wrapper computes all of these (ops/masked_batch.py:
// launch_plan, row_plan). Returns cudaGetLastError() after the launch, or -3
// for a plan that does not cover the output, an `out` that is not
// element-aligned, or an `aligned` or `period` that its rows do not have.
int masked_batch_bf16(const void* image, const void* seg, const void* firsts, int width,
                      const void* width_dev, void* out, int k, int hwc, int c, int group,
                      int grid_x, int grid_y, int aligned, int period, void* stream) {
  return launch<__nv_bfloat16>(image, seg, firsts, width, width_dev, out, k, hwc, c, group,
                               grid_x, grid_y, aligned, period, stream);
}

int masked_batch_f32(const void* image, const void* seg, const void* firsts, int width,
                     const void* width_dev, void* out, int k, int hwc, int c, int group,
                     int grid_x, int grid_y, int aligned, int period, void* stream) {
  return launch<float>(image, seg, firsts, width, width_dev, out, k, hwc, c, group, grid_x,
                       grid_y, aligned, period, stream);
}

}  // extern "C"
