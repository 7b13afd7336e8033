// Felzenszwalb-Huttenlocher graph-based image segmentation, and the host
// passes of SLIC and XRAI.
//
// The port's own redesign of the JAX package's kernel, which replaced the
// reference's scikit-image call (bayesian_active_learning_imagenet.py:150:
// felzenszwalb(img, scale=100, sigma=0.5, min_size=50)). The algorithm
// (Felzenszwalb & Huttenlocher, IJCV 2004) is a serial sorted-edge
// union-find, so it stays on the host, bound via ctypes.
//
// felzenszwalb_image is one pass from the image (uint8 or float32 [H, W, C])
// to int32 labels [H, W], contiguous 0..S-1 in raster first-occurrence
// order: the Gaussian pre-smoothing, the 8-connected edge weights, a stable
// radix sort of 8-byte keys, and the union-find, once per (scale, min_size)
// of a ladder. Its labels equal segment/felzenszwalb.py's numpy plain
// version (scipy's smoothing, numpy's stable argsort) bit for bit, so every
// float operation here keeps that version's order and precision; the
// library is built with -ffp-contract=off so that nothing fuses them.
//
// A thread keeps its buffers between calls (Workspace, thread_local): they
// grow to the largest image the thread has seen and are never freed, so a
// call allocates and faults in no memory once its thread has seen an image
// as large.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// Disjoint-set forest with union by size and path compression.
struct UnionFind {
  std::vector<int32_t> parent;
  std::vector<int32_t> size;
  std::vector<float> internal;  // max edge weight inside the component

  explicit UnionFind(int32_t n) : parent(n), size(n, 1), internal(n, 0.f) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }

  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  int32_t merge(int32_t a, int32_t b, float w) {
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    internal[a] = w;  // edges arrive sorted: w is the current max
    return a;
  }
};

}  // namespace

namespace {

// One thread's buffers for felzenszwalb_image. Each grows to the largest
// size asked of it and never shrinks; `grew` says whether a call grew any.
struct Workspace {
  std::vector<uint64_t> keys, spare;  // edge keys, the sort's second buffer
  std::vector<int32_t> parent, size, remap;
  std::vector<float> thr;       // per root: internal + scale / size
  std::vector<float> image, smoothed;  // [h, w, c]: from uint8; smoothed
  std::vector<double> acc, ext;  // a row's sums; a row reflected r pixels out
  bool grew = false;

  template <typename T>
  T* fit(std::vector<T>& v, int64_t n) {
    if (static_cast<int64_t>(v.size()) < n) {
      v.resize(n);
      grew = true;
    }
    return v.data();
  }
};

thread_local Workspace t_workspace;

// scipy.ndimage's mode="reflect" (d c b a | a b c d | d c b a): period 2n,
// so an index any distance outside [0, n) folds as often as it must.
inline int64_t reflect(int64_t i, int64_t n) {
  const int64_t period = 2 * n;
  int64_t m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

// Gaussian smoothing of a float32 [h, w, c] image into `out`, as
// scipy.ndimage.gaussian_filter(channel, sigma, output=float32,
// mode="reflect") gives it channel by channel: axis 0, then axis 1, each by
// NI_Correlate1D's symmetric form in float64 (the centre tap, then the
// pairs from the farthest in), rounded to float32 after each axis.
// taps[0..r] are _gaussian_kernel1d's centre and right half.
void smooth(const float* in, int32_t h, int32_t w, int32_t c,
            const double* taps, int32_t r, Workspace& ws, float* out) {
  const int64_t wc = static_cast<int64_t>(w) * c;
  double* acc = ws.fit(ws.acc, wc);
  double* ext = ws.fit(ws.ext, (static_cast<int64_t>(w) + 2 * r) * c);
  double* mid = ext + static_cast<int64_t>(r) * c;
  for (int32_t y = 0; y < h; ++y) {
    const float* row = in + y * wc;
    for (int64_t i = 0; i < wc; ++i)
      acc[i] = static_cast<double>(row[i]) * taps[0];
    for (int32_t k = r; k >= 1; --k) {
      const float* up = in + reflect(y - k, h) * wc;
      const float* down = in + reflect(y + k, h) * wc;
      for (int64_t i = 0; i < wc; ++i)
        acc[i] += (static_cast<double>(up[i]) + static_cast<double>(down[i])) *
                  taps[k];
    }
    // Axis 0's row, rounded to float32 as scipy stores it between the axes,
    // and reflected r pixels out either side for axis 1.
    for (int64_t i = 0; i < wc; ++i) mid[i] = static_cast<float>(acc[i]);
    for (int64_t x = 1; x <= r; ++x) {
      for (int32_t ch = 0; ch < c; ++ch) {
        mid[-x * c + ch] = mid[reflect(-x, w) * c + ch];
        mid[(w - 1 + x) * c + ch] = mid[reflect(w - 1 + x, w) * c + ch];
      }
    }
    for (int64_t i = 0; i < wc; ++i) acc[i] = mid[i] * taps[0];
    for (int32_t k = r; k >= 1; --k) {
      const double* left = mid - static_cast<int64_t>(k) * c;
      const double* right = mid + static_cast<int64_t>(k) * c;
      for (int64_t i = 0; i < wc; ++i) acc[i] += (left[i] + right[i]) * taps[k];
    }
    float* dst = out + y * wc;
    for (int64_t i = 0; i < wc; ++i) dst[i] = static_cast<float>(acc[i]);
  }
}

// The 8-connected edges as keys (weight bits << 32) | (p * 4 + d), emitted
// in raster order of p, then d: right (0), down (1), down-right (2),
// down-left (3). A weight sums the squared channel differences in float32 in
// channel order, then takes the square root. kC > 0 fixes the channel count
// at compile time (c == kC); 0 reads it from c. Returns the number of keys.
template <int kC>
int64_t build_keys(const float* s, int32_t h, int32_t w, int32_t c,
                   uint64_t* keys) {
  const int32_t channels = kC > 0 ? kC : c;
  const int64_t wc = static_cast<int64_t>(w) * channels;
  int64_t m = 0;
  auto emit = [&](int64_t p, uint32_t d, const float* a, const float* b) {
    float acc = 0.f;
    for (int32_t ch = 0; ch < channels; ++ch) {
      const float diff = a[ch] - b[ch];
      acc += diff * diff;
    }
    const float wt = std::sqrt(acc);
    uint32_t bits;
    std::memcpy(&bits, &wt, 4);
    keys[m++] = (static_cast<uint64_t>(bits) << 32) |
                (static_cast<uint32_t>(p) * 4u + d);
  };
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t p = static_cast<int64_t>(y) * w + x;
      const float* a = s + p * channels;
      if (x + 1 < w) emit(p, 0, a, a + channels);
      if (y + 1 < h) {
        emit(p, 1, a, a + wc);
        if (x + 1 < w) emit(p, 2, a, a + wc + channels);
        if (x > 0) emit(p, 3, a, a + wc - channels);
      }
    }
  }
  return m;
}

// Stable LSD radix sort of the keys by their weight bits alone (for
// non-negative floats, bit order is value order). The digits cover only the
// bits in which the weights differ: the sort runs on each weight's bits less
// the smallest's, in as few passes of at most 11 bits as that span needs
// (three for a 224^2 photo, none for a constant image). Every histogram
// comes from one read, and a pass whose digit is the same in every key is
// skipped. The keys were emitted in ascending (p, d), so equal weights keep
// that order, as numpy's stable argsort keeps it. Returns the buffer that
// holds the result: `keys` or `spare`.
uint64_t* sort_keys(uint64_t* keys, uint64_t* spare, int64_t m) {
  constexpr int kMaxBits = 11;
  uint32_t lo = 0xFFFFFFFFu, hi = 0;
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t bits = static_cast<uint32_t>(keys[i] >> 32);
    lo = std::min(lo, bits);
    hi = std::max(hi, bits);
  }
  int span = 0;
  while (span < 32 && m > 0 && ((hi - lo) >> span) != 0) ++span;
  if (span == 0) return keys;
  const int passes = (span + kMaxBits - 1) / kMaxBits;
  const int width = (span + passes - 1) / passes;
  const uint32_t mask = (1u << width) - 1;
  uint32_t hist[3][1 << kMaxBits] = {};
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t d = static_cast<uint32_t>(keys[i] >> 32) - lo;
    for (int pass = 0; pass < passes; ++pass)
      ++hist[pass][(d >> (width * pass)) & mask];
  }
  uint64_t* src = keys;
  uint64_t* dst = spare;
  for (int pass = 0; pass < passes; ++pass) {
    uint32_t* count = hist[pass];
    const int shift = width * pass;
    const uint32_t first =
        ((static_cast<uint32_t>(src[0] >> 32) - lo) >> shift) & mask;
    if (count[first] == static_cast<uint64_t>(m)) continue;
    uint32_t start = 0;
    for (uint32_t b = 0; b <= mask; ++b) {
      const uint32_t n_b = count[b];
      count[b] = start;
      start += n_b;
    }
    for (int64_t i = 0; i < m; ++i) {
      const uint64_t key = src[i];
      const uint32_t d = static_cast<uint32_t>(key >> 32) - lo;
      dst[count[(d >> shift) & mask]++] = key;
    }
    std::swap(src, dst);
  }
  return src;
}

inline int32_t find_root(int32_t* parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];  // path halving; it never changes a root
    x = parent[x];
  }
  return x;
}

// One (scale, min_size) segmentation over the sorted keys into `labels`.
void segment_keys(const uint64_t* keys, int64_t m, int32_t w, int64_t n,
                  float scale, int32_t min_size, Workspace& ws,
                  int32_t* labels) {
  int32_t* parent = ws.parent.data();
  int32_t* size = ws.size.data();
  float* thr = ws.thr.data();
  // Each root caches its merge threshold internal(C) + scale / |C|, by the
  // expression the plain version evaluates (internal 0 for one pixel).
  const float thr_one = 0.f + scale / 1;
  for (int64_t p = 0; p < n; ++p) {
    parent[p] = static_cast<int32_t>(p);
    size[p] = 1;
    thr[p] = thr_one;
  }
  const int32_t step[4] = {1, w, w + 1, w - 1};

  // Pass 1: merge when the weight is within both components' thresholds.
  for (int64_t i = 0; i < m; ++i) {
    const uint64_t key = keys[i];
    const int32_t a = static_cast<int32_t>(static_cast<uint32_t>(key) >> 2);
    int32_t ra = find_root(parent, a);
    int32_t rb = find_root(parent, a + step[key & 3u]);
    if (ra == rb) continue;
    const uint32_t bits = static_cast<uint32_t>(key >> 32);
    float wt;
    std::memcpy(&wt, &bits, 4);
    if (wt <= thr[ra] && wt <= thr[rb]) {
      if (size[ra] < size[rb]) std::swap(ra, rb);
      parent[rb] = ra;
      size[ra] += size[rb];
      thr[ra] = wt + scale / size[ra];  // sorted: wt is the new internal
    }
  }

  // Every pixel points at its root from here on.
  for (int64_t p = 0; p < n; ++p)
    parent[p] = find_root(parent, static_cast<int32_t>(p));

  // Pass 2: absorb components smaller than min_size along the sorted edges.
  if (min_size > 1) {
    for (int64_t i = 0; i < m; ++i) {
      const uint64_t key = keys[i];
      const int32_t a = static_cast<int32_t>(static_cast<uint32_t>(key) >> 2);
      const int32_t b = a + step[key & 3u];
      if (parent[a] == parent[b]) continue;  // flattened: one component
      int32_t ra = find_root(parent, a);
      int32_t rb = find_root(parent, b);
      if (ra == rb || (size[ra] >= min_size && size[rb] >= min_size)) continue;
      if (size[ra] < size[rb]) std::swap(ra, rb);
      parent[rb] = ra;
      size[ra] += size[rb];
    }
  }

  // Relabel contiguous in raster first-occurrence order.
  int32_t* remap = ws.remap.data();
  std::fill(remap, remap + n, -1);
  int32_t next = 0;
  for (int64_t p = 0; p < n; ++p) {
    const int32_t root = find_root(parent, static_cast<int32_t>(p));
    if (remap[root] < 0) remap[root] = next++;
    labels[p] = remap[root];
  }
}

// The image as float32 [h, w, c], smoothed (r >= 0) or not: uint8 as
// float32(x) / 255 (skimage's img_as_float, numpy's astype(float32) / 255.0),
// float32 as it is.
const float* prepare(const void* img, int32_t u8, int32_t h, int32_t w,
                     int32_t c, const double* taps, int32_t r, Workspace& ws) {
  const int64_t nc = static_cast<int64_t>(h) * w * c;
  const float* in = static_cast<const float*>(img);
  if (u8) {
    float lut[256];
    for (int v = 0; v < 256; ++v) lut[v] = static_cast<float>(v) / 255.0f;
    const uint8_t* px = static_cast<const uint8_t*>(img);
    float* f = ws.fit(ws.image, nc);
    for (int64_t i = 0; i < nc; ++i) f[i] = lut[px[i]];
    in = f;
  }
  if (r < 0) return in;
  float* out = ws.fit(ws.smoothed, nc);
  smooth(in, h, w, c, taps, r, ws, out);
  return out;
}

// The keys' (p, d) takes 32 bits: fewer than 2^30 pixels.
inline bool valid_shape(int32_t h, int32_t w, int32_t c) {
  return h > 0 && w > 0 && c > 0 && static_cast<int64_t>(h) * w < (1LL << 30);
}

}  // namespace

extern "C" {

// Felzenszwalb over an [h, w, c] image, uint8 (u8 != 0) or float32, smoothed
// by `taps` (see smooth; radius < 0: not smoothed), then segmented once per
// (scales[s], min_sizes[s]) into labels int32 [n_scales, h*w]. The
// smoothing, the keys and the sort are shared by the scales; each scale's
// labels equal a one-scale call's. Returns 1 where the thread's workspace
// grew, 0 where it was reused, -1 for a shape it cannot take.
int32_t felzenszwalb_image(const void* img, int32_t u8, int32_t h, int32_t w,
                           int32_t c, const double* taps, int32_t radius,
                           const float* scales, const int32_t* min_sizes,
                           int32_t n_scales, int32_t* labels) {
  if (!valid_shape(h, w, c)) return -1;
  Workspace& ws = t_workspace;
  ws.grew = false;
  const int64_t n = static_cast<int64_t>(h) * w;
  uint64_t* keys = ws.fit(ws.keys, 4 * n);
  uint64_t* spare = ws.fit(ws.spare, 4 * n);
  ws.fit(ws.parent, n);
  ws.fit(ws.size, n);
  ws.fit(ws.thr, n);
  ws.fit(ws.remap, n);
  const float* smoothed = prepare(img, u8, h, w, c, taps, radius, ws);
  const int64_t m = c == 3 ? build_keys<3>(smoothed, h, w, c, keys)
                           : build_keys<0>(smoothed, h, w, c, keys);
  const uint64_t* sorted = sort_keys(keys, spare, m);
  for (int32_t s = 0; s < n_scales; ++s)
    segment_keys(sorted, m, w, n, scales[s], min_sizes[s], ws,
                 labels + static_cast<int64_t>(s) * n);
  return ws.grew ? 1 : 0;
}

// felzenszwalb_image's smoothing alone, into float32 `out` [h, w, c] (the
// tests hold it against scipy). Returns as felzenszwalb_image.
int32_t felzenszwalb_smooth(const void* img, int32_t u8, int32_t h, int32_t w,
                            int32_t c, const double* taps, int32_t radius,
                            float* out) {
  if (!valid_shape(h, w, c)) return -1;
  Workspace& ws = t_workspace;
  ws.grew = false;
  const float* s = prepare(img, u8, h, w, c, taps, radius, ws);
  std::copy(s, s + static_cast<int64_t>(h) * w * c, out);
  return ws.grew ? 1 : 0;
}

// Connected components (4-connectivity) of an int32 label map: two pixels
// join iff adjacent AND equal input label. Writes component ids into `out`
// (contiguous, raster first-occurrence order) and returns the component
// count. Consumed by segment/slic.py's enforce_connectivity, replacing its
// per-label scipy.ndimage.label loop (one O(n alpha) pass instead of S
// passes; component IDENTITY is all the caller needs, so the id scheme
// only has to be deterministic, which first-occurrence order is).
int32_t label_components(const int32_t* labels, int32_t h, int32_t w,
                         int32_t* out) {
  const int64_t n = static_cast<int64_t>(h) * w;
  UnionFind uf(static_cast<int32_t>(n));
  auto join = [&uf](int64_t a, int64_t b) {
    const int32_t ra = uf.find(static_cast<int32_t>(a));
    const int32_t rb = uf.find(static_cast<int32_t>(b));
    if (ra != rb) uf.merge(ra, rb, 0.f);  // merge expects roots
  };
  for (int32_t y = 0; y < h; ++y) {
    const int64_t row = static_cast<int64_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = row + x;
      const int32_t lab = labels[i];
      if (x + 1 < w && labels[i + 1] == lab) join(i, i + 1);
      if (y + 1 < h && labels[i + w] == lab) join(i, i + w);
    }
  }
  std::vector<int32_t> remap(n, -1);
  int32_t next_id = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t root = uf.find(static_cast<int32_t>(i));
    if (remap[root] < 0) remap[root] = next_id++;
    out[i] = remap[root];
  }
  return next_id;
}

// Full SLIC connectivity postpass (segment/slic.py enforce_connectivity
// fast path): 4-connectivity CC of the label map, keep rule (a fragment
// survives iff its size >= max(1, min_fraction * the largest fragment of
// ITS label)), then adjacency absorption — each dropped fragment takes
// the label of the adjacent SURVIVING region it shares the longest
// boundary with (ties: smaller label id; fragments adjacent only to
// other dropped fragments resolve over rounds, so final labels are
// always spatially CONNECTED). Pure integer counting: the numpy twin in
// slic.py implements the identical spec bit-for-bit. Writes final labels
// (NOT relabeled) into `out`; returns the number of absorption rounds.
int32_t slic_postpass(const int32_t* labels, int32_t h, int32_t w,
                      float min_fraction, int32_t* out) {
  const int64_t n = static_cast<int64_t>(h) * w;
  // --- connected components (same spec as label_components) ---
  std::vector<int32_t> comp(n);
  int32_t n_comp;
  {
    UnionFind uf(static_cast<int32_t>(n));
    auto join = [&uf](int64_t a, int64_t b) {
      const int32_t ra = uf.find(static_cast<int32_t>(a));
      const int32_t rb = uf.find(static_cast<int32_t>(b));
      if (ra != rb) uf.merge(ra, rb, 0.f);
    };
    for (int32_t y = 0; y < h; ++y) {
      const int64_t row = static_cast<int64_t>(y) * w;
      for (int32_t x = 0; x < w; ++x) {
        const int64_t i = row + x;
        const int32_t lab = labels[i];
        if (x + 1 < w && labels[i + 1] == lab) join(i, i + 1);
        if (y + 1 < h && labels[i + w] == lab) join(i, i + w);
      }
    }
    std::vector<int32_t> remap(n, -1);
    n_comp = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int32_t root = uf.find(static_cast<int32_t>(i));
      if (remap[root] < 0) remap[root] = n_comp++;
      comp[i] = remap[root];
    }
  }
  // --- per-component size, label; keep rule ---
  std::vector<int64_t> sizes(n_comp, 0);
  std::vector<int32_t> comp_label(n_comp, 0);
  int32_t max_label = 0;
  for (int64_t i = 0; i < n; ++i) {
    sizes[comp[i]]++;
    comp_label[comp[i]] = labels[i];
    if (labels[i] > max_label) max_label = labels[i];
  }
  std::vector<int64_t> max_per_label(max_label + 1, 0);
  for (int32_t c = 0; c < n_comp; ++c)
    max_per_label[comp_label[c]] =
        std::max(max_per_label[comp_label[c]], sizes[c]);
  std::vector<char> assigned(n_comp);
  std::vector<int32_t> final_label(n_comp);
  int32_t unassigned = 0;
  for (int32_t c = 0; c < n_comp; ++c) {
    const double thr =
        std::max(1.0, static_cast<double>(min_fraction) *
                          static_cast<double>(max_per_label[comp_label[c]]));
    assigned[c] = sizes[c] >= thr ? 1 : 0;
    final_label[c] = comp_label[c];
    if (!assigned[c]) ++unassigned;
  }
  // --- adjacency absorption over rounds ---
  int32_t rounds = 0;
  if (unassigned > 0) {
    // Differing-comp neighbor pairs with an INITIALLY-DROPPED left side
    // (only those ever need an incoming label), counting-sorted by that
    // side once; groups then scan in O(edges) per round.
    std::vector<int32_t> ea, eb;
    ea.reserve(n / 4);
    eb.reserve(n / 4);
    auto add = [&](int64_t a, int64_t b) {
      const int32_t ca = comp[a], cb = comp[b];
      if (ca == cb) return;
      if (!assigned[ca]) {
        ea.push_back(ca);
        eb.push_back(cb);
      }
      if (!assigned[cb]) {
        ea.push_back(cb);
        eb.push_back(ca);
      }
    };
    for (int32_t y = 0; y < h; ++y) {
      const int64_t row = static_cast<int64_t>(y) * w;
      for (int32_t x = 0; x < w; ++x) {
        const int64_t i = row + x;
        if (x + 1 < w) add(i, i + 1);
        if (y + 1 < h) add(i, i + w);
      }
    }
    // Counting sort by ea (stable; O(E + n_comp)).
    const size_t n_edges = ea.size();
    std::vector<int32_t> cnt(n_comp + 1, 0);
    for (size_t k = 0; k < n_edges; ++k) cnt[ea[k] + 1]++;
    for (int32_t c = 0; c < n_comp; ++c) cnt[c + 1] += cnt[c];
    std::vector<int32_t> sa(n_edges), sb(n_edges);
    {
      std::vector<int32_t> pos(cnt.begin(), cnt.end() - 1);
      for (size_t k = 0; k < n_edges; ++k) {
        const int32_t p = pos[ea[k]]++;
        sa[p] = ea[k];
        sb[p] = eb[k];
      }
    }
    while (unassigned > 0) {
      ++rounds;
      // Decide this round from LAST round's assignments only (batch
      // semantics — matches the vectorized numpy twin).
      std::vector<int32_t> new_label(n_comp, -1);
      size_t e = 0;
      while (e < n_edges) {
        const int32_t ca = sa[e];
        size_t start = e;
        while (e < n_edges && sa[e] == ca) ++e;
        if (assigned[ca]) continue;
        // Boundary-length count per adjacent ASSIGNED label; ties ->
        // smaller label id.
        int64_t best_count = 0;
        int32_t best_label = -1;
        // Tiny local tally: comps touch few distinct labels.
        std::vector<std::pair<int32_t, int64_t>> tally;
        for (size_t k = start; k < e; ++k) {
          const int32_t cb = sb[k];
          if (!assigned[cb]) continue;
          const int32_t lb = final_label[cb];
          bool found = false;
          for (auto& t : tally)
            if (t.first == lb) {
              t.second++;
              found = true;
              break;
            }
          if (!found) tally.emplace_back(lb, 1);
        }
        for (const auto& t : tally)
          if (t.second > best_count ||
              (t.second == best_count && t.first < best_label)) {
            best_count = t.second;
            best_label = t.first;
          }
        if (best_label >= 0) new_label[ca] = best_label;
      }
      int32_t progressed = 0;
      for (int32_t c = 0; c < n_comp; ++c)
        if (new_label[c] >= 0) {
          final_label[c] = new_label[c];
          assigned[c] = 1;
          ++progressed;
        }
      unassigned -= progressed;
      if (progressed == 0) break;  // unreachable on a connected grid
    }
  }
  for (int64_t i = 0; i < n; ++i) out[i] = final_label[comp[i]];
  return rounds;
}

// XRAI greedy region ranking (saliency/xrai.py greedy_region_ranking's
// native twin — BIT-EXACT by replicating its float64 arithmetic and
// accumulation ORDER): repeatedly claim the segment with the highest
// uncovered-attribution density. The numpy path rescans the full image
// per claim (ids[m] == best, then whole-range bincount subtractions);
// here a one-time CSR of per-segment pixel lists makes each claim touch
// only its own pixels, and a stamp array confines the num/den updates
// to the segments actually touched (subtracting an all-zero bincount
// row is a no-op, so skipping it is exact). Per-segment deltas
// accumulate over claimed pixels in ascending order — the same order
// np.bincount sums — then subtract once, matching the numpy FP result
// bit-for-bit. attr: f64[hw]; maps: int32[n_maps, hw] (any label
// offset; min is subtracted per map like the numpy path); out_heat:
// f32[hw] rank-valued in (0, 1]. Returns the number of claimed regions.
int32_t xrai_greedy_rank(const double* attr, const int32_t* maps_in,
                         int32_t n_maps, int32_t hw_i, int32_t min_area,
                         float* out_heat) {
  const int64_t hw = hw_i;
  if (n_maps <= 0 || hw <= 0) return -1;

  std::vector<int32_t> counts(n_maps), offsets(n_maps);
  std::vector<int32_t> ids(static_cast<int64_t>(n_maps) * hw);
  int64_t s_total = 0;
  for (int32_t m = 0; m < n_maps; ++m) {
    const int32_t* sm = maps_in + static_cast<int64_t>(m) * hw;
    int32_t mn = sm[0], mx = sm[0];
    for (int64_t p = 1; p < hw; ++p) {
      mn = std::min(mn, sm[p]);
      mx = std::max(mx, sm[p]);
    }
    offsets[m] = static_cast<int32_t>(s_total);
    counts[m] = mx - mn + 1;
    int32_t* dst = ids.data() + static_cast<int64_t>(m) * hw;
    for (int64_t p = 0; p < hw; ++p) dst[p] = sm[p] - mn;
    s_total += counts[m];
  }

  // Initial tallies, ascending pixel order per map (np.bincount's order).
  std::vector<double> num(s_total, 0.0), den(s_total, 0.0);
  for (int32_t m = 0; m < n_maps; ++m) {
    const int32_t* idm = ids.data() + static_cast<int64_t>(m) * hw;
    const int64_t off = offsets[m];
    for (int64_t p = 0; p < hw; ++p) {
      num[off + idm[p]] += attr[p];
      den[off + idm[p]] += 1.0;
    }
  }

  // CSR: each global segment's pixel list, ascending (counting sort).
  std::vector<int64_t> seg_start(s_total + 1, 0);
  for (int32_t m = 0; m < n_maps; ++m) {
    const int32_t* idm = ids.data() + static_cast<int64_t>(m) * hw;
    const int64_t off = offsets[m];
    for (int64_t p = 0; p < hw; ++p) ++seg_start[off + idm[p] + 1];
  }
  for (int64_t s = 0; s < s_total; ++s) seg_start[s + 1] += seg_start[s];
  std::vector<int32_t> pix(static_cast<int64_t>(n_maps) * hw);
  {
    std::vector<int64_t> cursor(seg_start.begin(), seg_start.end() - 1);
    for (int32_t m = 0; m < n_maps; ++m) {
      const int32_t* idm = ids.data() + static_cast<int64_t>(m) * hw;
      const int64_t off = offsets[m];
      for (int64_t p = 0; p < hw; ++p)
        pix[cursor[off + idm[p]]++] = static_cast<int32_t>(p);
    }
  }

  std::vector<uint8_t> covered(hw, 0), alive(s_total);
  for (int64_t s = 0; s < s_total; ++s) alive[s] = den[s] >= min_area;
  std::vector<double> heat(hw, 0.0);
  std::vector<double> dnum(s_total, 0.0), dden(s_total, 0.0);
  std::vector<int32_t> stamp(s_total, 0);
  std::vector<int32_t> claimed;
  std::vector<int64_t> touched;
  claimed.reserve(hw);
  const double neg_inf = -std::numeric_limits<double>::infinity();

  int32_t rank = 0;
  int32_t claim_id = 0;  // stamps even rankless (fully-covered) claims
  while (true) {
    // First-maximum argmax over alive segments (np.argmax tie rule).
    double best_gain = neg_inf;
    int64_t best = -1;
    for (int64_t s = 0; s < s_total; ++s) {
      if (!alive[s]) continue;
      const double g = num[s] / std::max(den[s], 1.0);
      if (best < 0 || g > best_gain) {
        best_gain = g;
        best = s;
      }
    }
    if (best < 0) break;  // no segment alive
    alive[best] = 0;

    claimed.clear();
    for (int64_t k = seg_start[best]; k < seg_start[best + 1]; ++k) {
      const int32_t p = pix[k];
      if (!covered[p]) claimed.push_back(p);
    }
    if (claimed.empty()) continue;
    ++rank;
    for (const int32_t p : claimed) {
      covered[p] = 1;
      heat[p] = rank;
    }

    ++claim_id;
    touched.clear();
    for (int32_t mm = 0; mm < n_maps; ++mm) {
      const int32_t* idm = ids.data() + static_cast<int64_t>(mm) * hw;
      const int64_t off = offsets[mm];
      for (const int32_t p : claimed) {
        const int64_t g = off + idm[p];
        if (stamp[g] != claim_id) {
          stamp[g] = claim_id;
          dnum[g] = 0.0;
          dden[g] = 0.0;
          touched.push_back(g);
        }
        dnum[g] += attr[p];
        dden[g] += 1.0;
      }
    }
    for (const int64_t g : touched) {
      num[g] -= dnum[g];
      den[g] -= dden[g];
      if (!(den[g] >= min_area)) alive[g] = 0;
    }
  }

  const double denom = std::max(rank, 1);
  for (int64_t p = 0; p < hw; ++p)
    out_heat[p] = heat[p] > 0.0
        ? static_cast<float>((rank - heat[p] + 1.0) / denom)
        : 0.0f;
  return rank;
}

}  // extern "C"
