// B1: fused window-mask build + image masking + cast, for Hopper (sm_90a).
//
// Replaces the TPU kernel network_interpretation_imagenet_tpu/ops/
// pallas_masking.py:49 masked_batch_pallas (body _mask_apply_kernel, :34).
//
//   out[k, h, w, c] = cast(image[h, w, c] * [firsts[k] <= seg[h, w] < firsts[k] + width])
//
// Windows that run past the last segment clip, as the comparison does by
// itself. The product is taken in f32 and rounded once (round to nearest
// even), so the result is bit-identical to window_masks + apply_masks + cast.
//
// What bounds it on the H100: bytes. The output K*H*W*C*sizeof(T) dwarfs
// the inputs (the image and segment map are read by every mask but stay in
// L2): 301 KB per 224x224x3 bf16 mask, about 0.09 us per mask at 3.35 TB/s.
// Design: grid (pixels/8/256, K); each thread produces 8 consecutive
// output elements of one mask, loads firsts[k] itself, and writes them as
// one 16-byte store (two for f32). The TPU kernel's scalar prefetch and row
// tiling have no counterpart here. Left for later: fusing the build into
// the stem convolution's input load, which would remove the output round
// trip through device memory altogether.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_batch_kernel(const float* __restrict__ image, const int* __restrict__ seg,
                    const int* __restrict__ firsts, int width, T* __restrict__ out,
                    int hwc, int c) {
  const int k = blockIdx.y;
  const int i0 = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (i0 >= hwc) return;
  const int lo = __ldg(firsts + k);
  const int hi = lo + width;

  alignas(16) T v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = i0 + j;
    float x = 0.f;
    if (i < hwc) {
      const int s = __ldg(seg + i / c);
      const float keep = (s >= lo && s < hi) ? 1.f : 0.f;
      x = __ldg(image + i) * keep;
    }
    v[j] = from_float<T>(x);
  }

  T* dst = out + static_cast<long long>(k) * hwc + i0;
  if (i0 + kPerThread <= hwc && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(v);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int q = 0; q < static_cast<int>(sizeof(v) / 16); ++q) d[q] = src[q];
  } else {
    for (int j = 0; j < kPerThread && i0 + j < hwc; ++j) dst[j] = v[j];
  }
}

template <typename T>
int launch(const void* image, const void* seg, const void* firsts, int width,
           void* out, int k, int hwc, int c, void* stream) {
  const int vectors = (hwc + kPerThread - 1) / kPerThread;
  const dim3 grid((vectors + kThreads - 1) / kThreads, k);
  masked_batch_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<const int*>(seg),
      static_cast<const int*>(firsts), width, static_cast<T*>(out), hwc, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// image f32[H*W*C], seg i32[H*W], firsts i32[K] (all on the device) ->
// out[K*H*W*C]. Returns cudaGetLastError() after the launch.
int masked_batch_bf16(const void* image, const void* seg, const void* firsts,
                      int width, void* out, int k, int hwc, int c, void* stream) {
  return launch<__nv_bfloat16>(image, seg, firsts, width, out, k, hwc, c, stream);
}

int masked_batch_f32(const void* image, const void* seg, const void* firsts,
                     int width, void* out, int k, int hwc, int c, void* stream) {
  return launch<float>(image, seg, firsts, width, out, k, hwc, c, stream);
}

}  // extern "C"
