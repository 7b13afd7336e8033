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
// Design: each thread owns 8 consecutive elements of the H*W*C image. It
// loads their image values (two 16-byte loads) and segment ids once, then
// walks a group of masks: the block reads the group's starts into shared
// memory once, and for each mask the thread writes its 8 outputs as one
// 16-byte store (two for f32), a warp 512 contiguous bytes. The grid is
// (ceil(H*W*C / 8 / 256), ceil(K / group)), with the group from the Python
// wrapper (ops/masked_batch.py:launch_plan), so a block writes tens of KB and
// the image is read once per group instead of once per mask. C is a
// compile-time constant for RGB (C=3), so no integer division is left per
// element; other C take a generic instance. Left for later: fusing the build
// into the stem convolution's input load, which would remove the output's
// round trip through device memory altogether.

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

// CC > 0: the channel count at compile time; CC == 0: `c` at run time.
template <typename T, int CC>
__global__ void __launch_bounds__(kThreads)
b1_masked_batch(const float* __restrict__ image, const int* __restrict__ seg,
                const int* __restrict__ firsts, int width, const int* __restrict__ width_dev,
                T* __restrict__ out, int hwc, int c, int k_total, int group) {
  __shared__ int lo_s[kMaxGroup];
  const int k0 = blockIdx.y * group;
  const int nk = min(group, k_total - k0);
  if (threadIdx.x < nk) lo_s[threadIdx.x] = __ldg(firsts + k0 + threadIdx.x);
  __syncthreads();

  const int i0 = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (i0 >= hwc) return;
  const int cc = CC > 0 ? CC : c;
  const int wd = width_dev != nullptr ? __ldg(width_dev) : width;
  const bool full = i0 + kPerThread <= hwc;
  float x[kPerThread];
  int s[kPerThread];
  if (full) {
    const float4* src = reinterpret_cast<const float4*>(image + i0);
    const float4 a = __ldg(src), b = __ldg(src + 1);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = i0 + j < hwc ? i0 + j : hwc - 1;
    if (!full) x[j] = __ldg(image + i);
    s[j] = __ldg(seg + i / cc);
  }

  const bool vec = full && (reinterpret_cast<uintptr_t>(out + i0) & 15) == 0 &&
                   (static_cast<long long>(hwc) * sizeof(T)) % 16 == 0;
  T* dst = out + static_cast<long long>(k0) * hwc + i0;
  for (int k = 0; k < nk; ++k, dst += hwc) {
    const int lo = lo_s[k], hi = lo + wd;
    alignas(16) T v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      v[j] = from_float<T>(x[j] * ((s[j] >= lo && s[j] < hi) ? 1.f : 0.f));
    if (vec) {
      const uint4* src = reinterpret_cast<const uint4*>(v);
      uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
      for (int q = 0; q < static_cast<int>(sizeof(v) / 16); ++q) d[q] = src[q];
    } else {
      for (int j = 0; j < kPerThread && i0 + j < hwc; ++j) dst[j] = v[j];
    }
  }
}

template <typename T>
int launch(const void* image, const void* seg, const void* firsts, int width,
           const void* width_dev, void* out, int k, int hwc, int c, int group, int grid_x,
           int grid_y, void* stream) {
  if (group < 1 || group > kMaxGroup || grid_y != (k + group - 1) / group ||
      grid_x != (hwc + kPerThread * kThreads - 1) / (kPerThread * kThreads))
    return -3;  // a plan the kernel cannot run
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(image);
  const int* sg = static_cast<const int*>(seg);
  const int* fs = static_cast<const int*>(firsts);
  const int* wd = static_cast<const int*>(width_dev);
  T* o = static_cast<T*>(out);
  if (c == 3)
    b1_masked_batch<T, 3><<<grid, kThreads, 0, s>>>(im, sg, fs, width, wd, o, hwc, c, k, group);
  else
    b1_masked_batch<T, 0><<<grid, kThreads, 0, s>>>(im, sg, fs, width, wd, o, hwc, c, k, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// image f32[H*W*C], seg i32[H*W], firsts i32[K] (all on the device), width
// or (when not null) width_dev i32[1] on the device -> out[K*H*W*C]; masks
// go in groups of `group` (at most 64) per block row of the (grid_x, grid_y)
// grid. Returns cudaGetLastError() after the launch, or
// -3 for a plan that does not cover the output.
int masked_batch_bf16(const void* image, const void* seg, const void* firsts, int width,
                      const void* width_dev, void* out, int k, int hwc, int c, int group,
                      int grid_x, int grid_y, void* stream) {
  return launch<__nv_bfloat16>(image, seg, firsts, width, width_dev, out, k, hwc, c, group,
                               grid_x, grid_y, stream);
}

int masked_batch_f32(const void* image, const void* seg, const void* firsts, int width,
                     const void* width_dev, void* out, int k, int hwc, int c, int group,
                     int grid_x, int grid_y, void* stream) {
  return launch<float>(image, seg, firsts, width, width_dev, out, k, hwc, c, group, grid_x,
                       grid_y, stream);
}

}  // extern "C"
