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
// three points, as bottleneck_chain_xla (:163) does.
//
// Design: one templated implicit-GEMM convolution with a fused epilogue
// (bias, optional residual, ReLU, cast), launched three times per block.
// Activations are NHWC, so a 1x1 convolution is a plain [B*H*W, Cin] x
// [Cin, Cout] product and the 3x3 one gathers its A tile from nine shifted
// pixel rows (zero outside the image) with K = 9*Cin ordered (kh, kw, ci),
// which is the HWIO weight layout read as [9*Cin, Cout]. Tiles stream
// through shared memory with cp.async (zero-fill for padding and ragged
// edges). bf16 runs on the tensor cores through WMMA 16x16x16 fragments with
// f32 accumulators; the f32 instance (the parity mode) is a SIMT FMA loop.
// t1 and t2 go through device memory (scratch from the caller). The last
// 1x1 of every block after the first writes its output over its residual
// input in place: each thread reads the residual element it then writes.
//
// What bounds it on the H100, per image: 34*H*W*P^2 operations per block
// (8 + 18 + 8 from the three convolutions) against, at the least, reading x
// and writing y once per chain, 2*H*W*C*2 bytes. The card does 295 bf16
// operations per byte (989 TFLOP/s over 3.35 TB/s). ResNet-101's stage 1
// chain (2 blocks, P=64) does 272 per byte, so bytes bound it, narrowly;
// stages 2-4 do 816, 11968 and 2176, so operations bound them and the whole
// forward. The current design is far from that bound: WMMA
// (mma.sync) reaches a fraction of the rate of Hopper's wgmma, tiles are
// 128x64 with no warp specialisation, and t1/t2 make three extra trips
// through device memory per block. Left for later: wgmma with TMA loads, and
// keeping a block on chip, which on Hopper needs spatial tiles with a halo
// (one 56x56x64 bf16 t1 alone is 401 KB, more than the 227 KB of shared
// memory a block can use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile shapes. bf16: 128x64 output tile, 8 warps each holding 32x32 as 2x2
// WMMA fragments, K step 32, three-stage pipeline (43.5 KB of shared
// memory). f32: 64x64 tile, each thread 4x4 outputs, K step 16, two stages.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3, PAD = 8;
};
template <>
struct Cfg<float> {
  static constexpr int BM = 64, BN = 64, BK = 16, STAGES = 2, PAD = 4;
};

// Loads the A (activation) tiles of one output tile. Each thread copies the
// same 16-byte column of ITERS fixed rows at every K step, so the rows'
// pixel coordinates are computed once.
template <typename T, int KS>
struct ALoader {
  using C = Cfg<T>;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int VPR = C::BK / VEC;  // 16-byte vectors per tile row
  static constexpr int ITERS = C::BM * VPR / kThreads;
  static constexpr int LD = C::BK + C::PAD;

  long long m[ITERS];  // output pixel of the row, -1 past the end
  int h[ITERS], w[ITERS];
  int row0, kv;

  __device__ ALoader(long long m0, long long M, int H, int W) {
    row0 = threadIdx.x / VPR;
    kv = (threadIdx.x % VPR) * VEC;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const long long mi = m0 + row0 + i * (kThreads / VPR);
      m[i] = mi < M ? mi : -1;
      const long long mm = mi < M ? mi : 0;
      w[i] = static_cast<int>(mm % W);
      h[i] = static_cast<int>((mm / W) % H);
    }
  }

  __device__ void load(T* As, const T* A, int k0, int K, int H, int W, int Cin) const {
    const int k = k0 + kv;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      T* dst = As + (row0 + i * (kThreads / VPR)) * LD + kv;
      bool ok = m[i] >= 0 && k < K;
      const T* src = A;
      if (ok) {
        if (KS == 1) {
          src = A + m[i] * Cin + k;
        } else {
          const int tap = k / Cin;
          const int ci = k - tap * Cin;
          const int dh = tap / 3 - 1, dw = tap % 3 - 1;
          const int hi = h[i] + dh, wi = w[i] + dw;
          ok = hi >= 0 && hi < H && wi >= 0 && wi < W;
          if (ok) src = A + (m[i] + static_cast<long long>(dh) * W + dw) * Cin + ci;
        }
      }
      cp_async16(dst, src, ok);
    }
  }
};

// Loads the B (weight, [K, Cout] row-major) tile: one 16-byte vector per thread.
template <typename T>
__device__ __forceinline__ void load_b(T* Bs, const T* Wt, int k0, int n0, int K, int Cout) {
  using C = Cfg<T>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = C::BN / VEC;
  static_assert(C::BK * VPR == kThreads, "one B vector per thread");
  const int r = threadIdx.x / VPR;
  const int c = (threadIdx.x % VPR) * VEC;
  const bool ok = k0 + r < K && n0 + c < Cout;
  const T* src = ok ? Wt + static_cast<long long>(k0 + r) * Cout + n0 + c : Wt;
  cp_async16(Bs + r * (C::BN + C::PAD) + c, src, ok);
}

// out[m, n] = act(sum_k A[m, k] * Wt[k, n] + bias[n] (+ residual[m, n])),
// with A the implicit im2col of the NHWC input for a KS x KS, stride-1,
// same-padded convolution. `residual` may alias `out`.
template <int KS>
__global__ void __launch_bounds__(kThreads)
conv_gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
               const float* __restrict__ bias, const bf16* residual, bf16* out,
               long long M, int H, int W, int Cin, int Cout) {
  using C = Cfg<bf16>;
  constexpr int LDA = C::BK + C::PAD, LDB = C::BN + C::PAD, LDC = C::BN + 4;
  constexpr int A_ELEMS = C::BM * LDA, STAGE_ELEMS = A_ELEMS + C::BK * LDB;
  constexpr int PIPE_BYTES = C::STAGES * STAGE_ELEMS * 2;
  constexpr int C_BYTES = C::BM * LDC * 4;
  constexpr int SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem_raw[SMEM];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int K = KS * KS * Cin;
  const int nk = (K + C::BK - 1) / C::BK;
  const long long m0 = static_cast<long long>(blockIdx.x) * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const ALoader<bf16, KS> aload(m0, M, H, W);

  const int warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) {
      aload.load(smem + s * STAGE_ELEMS, A, s * C::BK, K, H, W, Cin);
      load_b(smem + s * STAGE_ELEMS + A_ELEMS, Wt, s * C::BK, n0, K, Cout);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int pf = kt + C::STAGES - 1;
    if (pf < nk) {
      bf16* st = smem + (pf % C::STAGES) * STAGE_ELEMS;
      aload.load(st, A, pf * C::BK, K, H, W, Cin);
      load_b(st + A_ELEMS, Wt, pf * C::BK, n0, K, Cout);
    }
    cp_async_commit();

    const bf16* As = smem + (kt % C::STAGES) * STAGE_ELEMS;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: accumulators -> shared f32 tile -> 8 outputs per thread step.
  float* Cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  constexpr int VPR = C::BN / 8;
#pragma unroll
  for (int it = 0; it < C::BM * VPR / kThreads; ++it) {
    const int v = threadIdx.x + it * kThreads;
    const int row = v / VPR;
    const int col = (v % VPR) * 8;
    const long long m = m0 + row;
    const int n = n0 + col;
    if (m >= M || n >= Cout) continue;
    float r[8];
    const float4* cs = reinterpret_cast<const float4*>(Cs + row * LDC + col);
    const float4* bs = reinterpret_cast<const float4*>(bias + n);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 c4 = cs[q];
      const float4 b4 = __ldg(bs + q);
      r[4 * q + 0] = c4.x + b4.x;
      r[4 * q + 1] = c4.y + b4.y;
      r[4 * q + 2] = c4.z + b4.z;
      r[4 * q + 3] = c4.w + b4.w;
    }
    const long long off = m * Cout + n;
    if (residual != nullptr) {
      const uint4 raw = *reinterpret_cast<const uint4*>(residual + off);
      const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(rp[q]);
        r[2 * q] += f.x;
        r[2 * q + 1] += f.y;
      }
    }
    uint4 packed;
    __nv_bfloat162* pp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pp[q] = __floats2bfloat162_rn(fmaxf(r[2 * q], 0.f), fmaxf(r[2 * q + 1], 0.f));
    *reinterpret_cast<uint4*>(out + off) = packed;
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads)
conv_gemm_f32(const float* __restrict__ A, const float* __restrict__ Wt,
              const float* __restrict__ bias, const float* residual, float* out,
              long long M, int H, int W, int Cin, int Cout) {
  using C = Cfg<float>;
  constexpr int LDA = C::BK + C::PAD, LDB = C::BN + C::PAD;
  constexpr int A_ELEMS = C::BM * LDA, STAGE_ELEMS = A_ELEMS + C::BK * LDB;
  __shared__ __align__(128) float smem[C::STAGES * STAGE_ELEMS];

  const int K = KS * KS * Cin;
  const int nk = (K + C::BK - 1) / C::BK;
  const long long m0 = static_cast<long long>(blockIdx.x) * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const ALoader<float, KS> aload(m0, M, H, W);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) {
      aload.load(smem + s * STAGE_ELEMS, A, s * C::BK, K, H, W, Cin);
      load_b(smem + s * STAGE_ELEMS + A_ELEMS, Wt, s * C::BK, n0, K, Cout);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int pf = kt + C::STAGES - 1;
    if (pf < nk) {
      float* st = smem + (pf % C::STAGES) * STAGE_ELEMS;
      aload.load(st, A, pf * C::BK, K, H, W, Cin);
      load_b(st + A_ELEMS, Wt, pf * C::BK, n0, K, Cout);
    }
    cp_async_commit();

    const float* As = smem + (kt % C::STAGES) * STAGE_ELEMS;
    const float* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * LDB + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[(ty * 4 + i) * LDA + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
  }
  cp_async_wait<0>();

  const int n = n0 + tx * 4;
  if (n >= Cout) return;
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + n));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const long long off = m * Cout + n;
    float4 r = make_float4(acc[i][0] + b4.x, acc[i][1] + b4.y, acc[i][2] + b4.z,
                           acc[i][3] + b4.w);
    if (residual != nullptr) {
      const float4 x = *reinterpret_cast<const float4*>(residual + off);
      r.x += x.x;
      r.y += x.y;
      r.z += x.z;
      r.w += x.w;
    }
    r.x = fmaxf(r.x, 0.f);
    r.y = fmaxf(r.y, 0.f);
    r.z = fmaxf(r.z, 0.f);
    r.w = fmaxf(r.w, 0.f);
    *reinterpret_cast<float4*>(out + off) = r;
  }
}

template <typename T, int KS>
void conv(const T* a, const void* w, const void* b, const T* res, T* out, long long M,
          int H, int W, int Cin, int Cout, cudaStream_t s) {
  using C = Cfg<T>;
  const dim3 grid(static_cast<unsigned>((M + C::BM - 1) / C::BM), (Cout + C::BN - 1) / C::BN);
  if constexpr (sizeof(T) == 2) {
    conv_gemm_bf16<KS><<<grid, kThreads, 0, s>>>(a, static_cast<const T*>(w),
                                                 static_cast<const float*>(b), res, out, M,
                                                 H, W, Cin, Cout);
  } else {
    conv_gemm_f32<KS><<<grid, kThreads, 0, s>>>(a, static_cast<const T*>(w),
                                                static_cast<const float*>(b), res, out, M,
                                                H, W, Cin, Cout);
  }
}

template <typename T>
int chain(const void* x, void* out, void* t1, void* t2, const void* const* w, int n_blocks,
          int B, int H, int W, int C, int P, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(B) * H * W;
  const T* in = static_cast<const T*>(x);
  T* y = static_cast<T*>(out);
  T* a = static_cast<T*>(t1);
  T* b = static_cast<T*>(t2);
  for (int i = 0; i < n_blocks; ++i) {
    const void* const* wb = w + 6 * i;  // w1, b1, w3, b3, w2, b2
    conv<T, 1>(in, wb[0], wb[1], nullptr, a, M, H, W, C, P, s);
    conv<T, 3>(a, wb[2], wb[3], nullptr, b, M, H, W, P, P, s);
    conv<T, 1>(b, wb[4], wb[5], in, y, M, H, W, P, C, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = y;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: [B, H, W, C] NHWC; t1, t2: [B, H, W, P] scratch; w: host array of
// 6*n_blocks device pointers per block (w1 [C, P], b1 f32 [P], w3 [3, 3, P, P],
// b3 f32 [P], w2 [P, C], b2 f32 [C]). Returns cudaGetLastError().
int bottleneck_chain_bf16(const void* x, void* out, void* t1, void* t2, const void* const* w,
                          int n_blocks, int B, int H, int W, int C, int P, void* stream) {
  return chain<bf16>(x, out, t1, t2, w, n_blocks, B, H, W, C, P, stream);
}

int bottleneck_chain_f32(const void* x, void* out, void* t1, void* t2, const void* const* w,
                         int n_blocks, int B, int H, int W, int C, int P, void* stream) {
  return chain<float>(x, out, t1, t2, w, n_blocks, B, H, W, C, P, stream);
}

}  // extern "C"
