// 16 bytes of bf16 or f32 as floats and back, for the kernels that move
// activations in 16-byte words (P1 pool_nhwc.cu, E1 epilogue_nhwc.cu).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

// 16 bytes of T as floats, and back (round to nearest even); round() a
// float to T's precision.
template <typename T>
struct Word;

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
  static constexpr unsigned kNegInf = 0xff80ff80u;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[kN]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float round(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
};

template <>
struct Word<float> {
  static constexpr int kN = 4;
  static constexpr unsigned kNegInf = 0xff800000u;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float round(float f) { return f; }
};
