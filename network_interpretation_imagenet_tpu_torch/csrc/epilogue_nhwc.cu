// E1: the epilogue of a convolution on its channels_last (NHWC) output, in
// one pass, in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the bias add, the residual
// add and ReLU after each convolution to XLA, which fuses them into the
// convolution. It was added for the folded ResNet plan
// (models/resnet_imagenet.py:FoldedResNet), whose eager blocks ran each of
// them as a library kernel of its own after cuDNN's convolution (which takes
// no bias there): in a forward of 256 of ResNeXt-101 32x8d, 104 broadcast
// bias adds (23.9 ms), 100 ReLUs (10.1 ms) and 33 residual adds (4.5 ms) of
// a 59.5 ms forward (PERF.md). Over y [m, c] (m = B*H*W rows of c channels):
//
//   y[m, c] = round(relu((f32(y[m, c]) + bias[c]) + f32(res[m, c])))
//
// with the bias f32 [c], the residual optional (y's shape and type, not
// overlapping y), the two sums in f32 in that order, and one rounding to
// y's type (round to nearest even). relu keeps a NaN and -0 (x < 0 ? 0 : x),
// as torch.relu does, so the plain twin (ops/epilogue_nhwc.py) gives the
// same bits.
//
// What bounds it on the H100: bytes. It does three adds an element; it has
// to read y (and the residual) once and write y once: at B=256 in bf16 the
// 100 epilogues of a ResNeXt-101 forward move 35.0 GB, 10.4 ms at 3.35 TB/s.
//
// Design, for a pass bound by bytes: one read and one write of each 16-byte
// word (8 bf16 or 4 f32 channels), and nothing else. A thread owns one word
// column v of the rows (the channels [v * kN, v * kN + kN)), keeps that
// column's bias in registers, and walks the rows r0, r0 + R, r0 + 2R, ...
// (R = rows_per_pass, ops/epilogue_nhwc.py:rows_per_pass), kUnroll of them
// at once, so that each thread has kUnroll words of y and of the residual
// in flight before it computes. Thread t starts at word t of the flat
// [m, c / kN] array and steps by R * c / kN words, so a warp's loads and
// stores each cover 512 contiguous bytes. The grid is R * c / kN threads:
// the wrapper sizes R so that there are about 132 x 2,048 of them (as many
// as the H100's SMs can hold at once), each walking m / R rows, or one row
// a thread where the tensor has fewer words than that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "word16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T, bool kResidual>
__device__ __forceinline__ uint4 epilogue(const uint4& yw, const uint4& rw,
                                          const float (&bias)[Word<T>::kN]) {
  using W = Word<T>;
  float f[W::kN], g[W::kN];
  W::unpack(yw, f);
  if (kResidual) W::unpack(rw, g);
#pragma unroll
  for (int j = 0; j < W::kN; ++j) {
    float s = __fadd_rn(f[j], bias[j]);
    if (kResidual) s = __fadd_rn(s, g[j]);
    f[j] = s < 0.f ? 0.f : s;
  }
  return W::pack(f);
}

// y: [m, cv] words, updated in place; res: [m, cv] words (read only when
// kResidual); bias: [cv * kN] floats, 16-byte aligned. Thread t < threads =
// rows_per_pass * cv owns word column t % cv and words t, t + step, ...,
// step = threads, of the n = m * cv words.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    e1_epilogue_nhwc(uint4* y, const uint4* __restrict__ res, const float* __restrict__ bias,
                     int cv, long long n, long long threads) {
  using W = Word<T>;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= threads) return;
  const int v = static_cast<int>(t % cv);
  float b[W::kN];
  const float4* b4 = reinterpret_cast<const float4*>(bias) + v * (W::kN / 4);
#pragma unroll
  for (int q = 0; q < W::kN / 4; ++q) {
    const float4 u = __ldg(b4 + q);
    b[4 * q] = u.x;
    b[4 * q + 1] = u.y;
    b[4 * q + 2] = u.z;
    b[4 * q + 3] = u.w;
  }
  const long long step = threads;
  long long i = t;
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  for (; i + (kUnroll - 1) * step < n; i += kUnroll * step) {
    uint4 a[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = y[i + u * step];
      r[u] = kResidual ? __ldg(res + i + u * step) : none;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[i + u * step] = epilogue<T, kResidual>(a[u], r[u], b);
  }
  for (; i < n; i += step)
    y[i] = epilogue<T, kResidual>(y[i], kResidual ? __ldg(res + i) : none, b);
}

template <typename T>
int launch(void* y, const void* res, const void* bias, int m, int c, int rows_per_pass,
           void* stream) {
  constexpr int kV = 16 / sizeof(T);
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(res) |
                            reinterpret_cast<uintptr_t>(bias);
  if (m < 1 || c < kV || c % kV != 0 || rows_per_pass < 1 || rows_per_pass > m || !y || !bias ||
      (aligned & 15) != 0)
    return -3;  // an input the kernel cannot run
  const int cv = c / kV;
  const long long threads = static_cast<long long>(rows_per_pass) * cv;
  if (threads > 0x7fffffffLL * kThreads) return -3;
  const long long n = static_cast<long long>(m) * cv;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* yw = static_cast<uint4*>(y);
  const uint4* rw = static_cast<const uint4*>(res);
  const float* b = static_cast<const float*>(bias);
  if (res)
    e1_epilogue_nhwc<T, true><<<blocks, kThreads, 0, s>>>(yw, rw, b, cv, n, threads);
  else
    e1_epilogue_nhwc<T, false><<<blocks, kThreads, 0, s>>>(yw, rw, b, cv, n, threads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y[m, c] on the device, channels last, updated in place; res (y's shape and
// type, not overlapping y) or null; bias f32 [c]; each on a 16-byte boundary,
// c a multiple of 16 bytes' elements; rows_per_pass (1 to m) the rows the
// grid covers at once (ops/epilogue_nhwc.py:rows_per_pass). Returns
// cudaGetLastError() after the launch, or -3 for an input the kernel does
// not take.
int epilogue_nhwc_bf16(void* y, const void* res, const void* bias, int m, int c,
                       int rows_per_pass, void* stream) {
  return launch<__nv_bfloat16>(y, res, bias, m, c, rows_per_pass, stream);
}

int epilogue_nhwc_f32(void* y, const void* res, const void* bias, int m, int c,
                      int rows_per_pass, void* stream) {
  return launch<float>(y, res, bias, m, c, rows_per_pass, stream);
}

}  // extern "C"
