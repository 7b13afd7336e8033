// P1: the 3x3 pools of a channels_last (NHWC) activation, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's pools are XLA's reduce_window
// (flax's avg_pool and max_pool). It was added for the module plan's
// Inception-v3 (models/inception.py), whose 13 pools a forward took 16.7 ms
// of a 37.9 ms forward of 256 in PyTorch's own NHWC pool kernels (PERF.md):
//
//   avg, stride 1, pad 1: out[n, y, x, c] = (sum of in[n, y-1..y+1, x-1..x+1, c],
//                                            zeros outside the image) / 9
//   max, stride 2, VALID: out[n, y, x, c] = max of in[n, 2y..2y+2, 2x..2x+2, c]
//
// and their gradients, for a net that autograd records (training, the
// gradient attributions): the average pool's is the same stencil over the
// output's gradient, each term divided by 9 and rounded to the input's type
// (kAvgGrad); the max pool's gathers, for each input, the gradients of the
// windows whose first largest value it is (p1_pool_nhwc_max_grad).
//
// What bounds it on the H100: bytes. A pool need only read its input once
// and write its output once; at B=256 in bf16 Inception-v3's nine average
// pools move 2.05 GB and its four max pools 1.86 GB, 1.17 ms at 3.35 TB/s.
// PyTorch's kernels take one output element a thread, read the window's 9
// values with 2-byte loads, and reuse nothing across outputs.
//
// Design: a thread owns one 16-byte vector of channels (8 bf16 or 4 f32;
// every channel count of the net is a multiple of 8) of one output column,
// and walks a strip of up to 8 output rows of it. It keeps the window's
// three input rows (three columns each, 16-byte words) in registers, and
// going down the strip loads only the rows the window moves onto: one a row
// at stride 1, two at stride 2. So the rows are read once a strip, and
// the strips' edges once more. Neighbouring threads own neighbouring
// vectors and columns, so each load and store instruction of a warp covers
// 512 contiguous bytes of a row, and the columns that the windows of
// neighbouring outputs share are found in L1. The grid is one thread per
// (image, strip, column, vector), in that order from the slowest; the Python
// wrapper (ops/pool_nhwc.py:strip_rows) picks the strip's height so that
// every shape of the net at B=256 gives over 2 x 132 x 2,048 threads, and at
// small batches takes strips of one row.
// Arithmetic: the sum is taken in f32 from 0 over the window in row-major
// order, values outside the image skipped (adding +0 changes no sum),
// divided by 9 and rounded once to the output type; max keeps the first
// largest value in row-major order and any NaN, from -inf. That is what
// PyTorch's avg_pool2d_out_cuda_frame_nhwc and max_pool_forward_nhwc
// compute, so the result is theirs to the bit; the gradients add in the
// order PyTorch's NHWC backward kernels do, and the average's terms are
// divided and rounded where they are there (its scalar_t / int quotient).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "word16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStrip = 8;  // ops/pool_nhwc.py:MAX_STRIP

enum Kind { kAvg = 0, kMax = 1, kAvgGrad = 2 };  // ops/pool_nhwc.py:_KIND

// x: [n, h, w, cv] words, out: [n, oh, ow, cv] words. Thread t owns vector
// t % cv of column (t / cv) % ow in strip (t / cv / ow) % strips of image
// t / cv / ow / strips: output rows [strip * s, min(strip * (s + 1), oh)).
// Outside the image a window reads the reduction's identity (+0 or -inf).
template <typename T, Kind kKind>
__global__ void __launch_bounds__(kThreads, 3)
    p1_pool_nhwc(const uint4* __restrict__ x, uint4* __restrict__ out, int h, int w, int cv,
                 int oh, int ow, int strip, int strips, long long total) {
  using W = Word<T>;
  constexpr bool kIsMax = kKind == kMax;
  constexpr int kStride = kIsMax ? 2 : 1;
  constexpr int kPad = kIsMax ? 0 : 1;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int v = static_cast<int>(t % cv);
  long long r = t / cv;
  const int ox = static_cast<int>(r % ow);
  r /= ow;
  const int s = static_cast<int>(r % strips);
  const long long n = r / strips;
  const int oy0 = s * strip, oy1 = min(oy0 + strip, oh);
  const int x0 = ox * kStride - kPad;
  const uint4* src = x + n * h * w * cv + v;
  uint4* dst = out + (n * oh * ow + ox) * cv + v;
  const unsigned id = kIsMax ? W::kNegInf : 0u;
  const uint4 identity = make_uint4(id, id, id, id);
  bool col[3];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) col[dx] = x0 + dx >= 0 && x0 + dx < w;

  uint4 win[3][3];  // the window's rows, top first; three columns each
  auto load = [&](int iy, uint4(&row)[3]) {
    const bool in = iy >= 0 && iy < h;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      row[dx] = in && col[dx]
                    ? __ldg(src + (static_cast<long long>(iy) * w + x0 + dx) * cv)
                    : identity;
  };
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) load(oy0 * kStride - kPad + dy, win[dy]);

  for (int oy = oy0;;) {
    float acc[W::kN];
#pragma unroll
    for (int j = 0; j < W::kN; ++j) acc[j] = kIsMax ? __uint_as_float(0xff800000u) : 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float f[W::kN];
        W::unpack(win[dy][dx], f);
#pragma unroll
        for (int j = 0; j < W::kN; ++j) {
          if (kIsMax)
            acc[j] = (f[j] > acc[j] || f[j] != f[j]) ? f[j] : acc[j];  // NaN wins
          else if (kKind == kAvgGrad)
            acc[j] += W::round(f[j] / 9.f);
          else
            acc[j] += f[j];
        }
      }
    if (kKind == kAvg) {
#pragma unroll
      for (int j = 0; j < W::kN; ++j) acc[j] = acc[j] / 9.f;
    }
    dst[static_cast<long long>(oy) * ow * cv] = W::pack(acc);
    if (++oy >= oy1) break;
    // Down one output row: the window moves kStride input rows.
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if (dy + kStride < 3) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) win[dy][dx] = win[dy + kStride][dx];
      } else {
        load(oy * kStride - kPad + dy, win[dy]);
      }
    }
  }
}

// The max pool's gradient: x [n, h, w, cv] and g [n, oh, ow, cv] words in,
// dx [n, h, w, cv] out. Thread t owns vector t % cv of input (n, iy, ix), t
// in that order, and adds in f32, over the windows that hold it (output rows
// then columns, ascending), the gradient of each whose first largest value
// (a NaN wins, as in the forward) it is: the window's scan is done again
// from x, which is read from L1 and L2 by the neighbouring threads too.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    p1_pool_nhwc_max_grad(const uint4* __restrict__ x, const uint4* __restrict__ g,
                          uint4* __restrict__ dx, int h, int w, int cv, int oh, int ow,
                          long long total) {
  using W = Word<T>;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int v = static_cast<int>(t % cv);
  long long r = t / cv;
  const int ix = static_cast<int>(r % w);
  r /= w;
  const int iy = static_cast<int>(r % h);
  const long long n = r / h;
  const int oy0 = iy < 3 ? 0 : (iy - 3) / 2 + 1, oy1 = min(iy / 2 + 1, oh);
  const int ox0 = ix < 3 ? 0 : (ix - 3) / 2 + 1, ox1 = min(ix / 2 + 1, ow);
  const uint4* src = x + n * h * w * cv + v;
  const uint4* grad = g + n * oh * ow * cv + v;
  float acc[W::kN];
#pragma unroll
  for (int j = 0; j < W::kN; ++j) acc[j] = 0.f;
  for (int oy = oy0; oy < oy1; ++oy)
    for (int ox = ox0; ox < ox1; ++ox) {
      float best[W::kN];
      int at[W::kN];
#pragma unroll
      for (int j = 0; j < W::kN; ++j) {
        best[j] = __uint_as_float(0xff800000u);
        at[j] = 0;
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dxx = 0; dxx < 3; ++dxx) {
          float f[W::kN];
          W::unpack(__ldg(src + (static_cast<long long>(2 * oy + dy) * w + 2 * ox + dxx) * cv),
                    f);
#pragma unroll
          for (int j = 0; j < W::kN; ++j)
            if (f[j] > best[j] || f[j] != f[j]) {
              best[j] = f[j];
              at[j] = dy * 3 + dxx;
            }
        }
      const int mine = (iy - 2 * oy) * 3 + (ix - 2 * ox);
      float gv[W::kN];
      W::unpack(__ldg(grad + (static_cast<long long>(oy) * ow + ox) * cv), gv);
#pragma unroll
      for (int j = 0; j < W::kN; ++j)
        if (at[j] == mine) acc[j] += gv[j];
    }
  dx[t] = W::pack(acc);
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, int kind, int strip,
           void* stream) {
  constexpr int kV = 16 / sizeof(T);
  const int stride = kind == kMax ? 2 : 1, pad = kind == kMax ? 0 : 1;
  const int cv = c / kV;
  const int oh = (h + 2 * pad - 3) / stride + 1, ow = (w + 2 * pad - 3) / stride + 1;
  const int strips = strip < 1 ? 0 : (oh + strip - 1) / strip;
  const long long total = static_cast<long long>(n) * strips * ow * cv;
  if (kind < kAvg || kind > kAvgGrad || n < 1 || c < kV || c % kV != 0 || h < 3 - 2 * pad ||
      w < 3 - 2 * pad || strip < 1 || strip > kMaxStrip ||
      total > 0x7fffffffLL * kThreads || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return -3;  // an input the kernel cannot run
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* in = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (kind == kMax)
    p1_pool_nhwc<T, kMax><<<blocks, kThreads, 0, s>>>(in, o, h, w, cv, oh, ow, strip, strips,
                                                     total);
  else if (kind == kAvg)
    p1_pool_nhwc<T, kAvg><<<blocks, kThreads, 0, s>>>(in, o, h, w, cv, oh, ow, strip, strips,
                                                     total);
  else
    p1_pool_nhwc<T, kAvgGrad><<<blocks, kThreads, 0, s>>>(in, o, h, w, cv, oh, ow, strip,
                                                         strips, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_max_grad(const void* x, const void* g, void* dx, int n, int h, int w, int c,
                    void* stream) {
  constexpr int kV = 16 / sizeof(T);
  const int cv = c / kV;
  const int oh = (h - 3) / 2 + 1, ow = (w - 3) / 2 + 1;
  const long long total = static_cast<long long>(n) * h * w * cv;
  if (n < 1 || c < kV || c % kV != 0 || h < 3 || w < 3 || total > 0x7fffffffLL * kThreads ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(dx)) & 15) != 0)
    return -3;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  p1_pool_nhwc_max_grad<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(g), static_cast<uint4*>(dx), h, w,
      cv, oh, ow, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x[n, h, w, c] and out on the device, channels last, each on a 16-byte
// boundary, c a multiple of 16 bytes' elements; kind 0 the average pool
// (stride 1, pad 1: out is [n, h, w, c]), 1 the VALID max pool (stride 2:
// [n, (h - 1) / 2, (w - 1) / 2, c]), 2 the average pool's gradient (x the
// output's gradient); strip output rows a thread (1 to 8,
// ops/pool_nhwc.py:strip_rows). Returns cudaGetLastError() after the
// launch, or -3 for an input the kernel does not take.
int pool_nhwc_bf16(const void* x, void* out, int n, int h, int w, int c, int kind, int strip,
                   void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, kind, strip, stream);
}

int pool_nhwc_f32(const void* x, void* out, int n, int h, int w, int c, int kind, int strip,
                  void* stream) {
  return launch<float>(x, out, n, h, w, c, kind, strip, stream);
}

// The max pool's gradient: x[n, h, w, c] the pool's input, g its output's
// gradient [n, (h - 1) / 2, (w - 1) / 2, c], dx[n, h, w, c] written; the
// layout and alignment as above.
int pool_nhwc_max_grad_bf16(const void* x, const void* g, void* dx, int n, int h, int w, int c,
                            void* stream) {
  return launch_max_grad<__nv_bfloat16>(x, g, dx, n, h, w, c, stream);
}

int pool_nhwc_max_grad_f32(const void* x, const void* g, void* dx, int n, int h, int w, int c,
                           void* stream) {
  return launch_max_grad<float>(x, g, dx, n, h, w, c, stream);
}

}  // extern "C"
