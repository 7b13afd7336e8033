// Felzenszwalb-Huttenlocher graph-based image segmentation.
//
// First-party native kernel replacing the reference's scikit-image call
// (bayesian_active_learning_imagenet.py:150: felzenszwalb(img, scale=100,
// sigma=0.5, min_size=50)). The algorithm (Felzenszwalb & Huttenlocher,
// IJCV 2004) is inherently serial (sorted-edge union-find), so it lives on
// the host as a C shared library bound via ctypes; the TPU path uses
// segment/slic.py instead.
//
// Input: gaussian-pre-smoothed float32 image [H, W, C] in [0, 1] (smoothing
// happens in Python so numpy and C++ paths share it bit-for-bit).
// Output: int32 labels [H, W], contiguous 0..S-1 in raster first-occurrence
// order. Returns the number of segments.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Edge {
  float w;
  int32_t a;
  int32_t b;
};

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

// LSD radix sort of edges by weight, 4 passes of 8 bits over the float's
// bit pattern. Edge weights are sqrt sums (>= 0, no NaN), and for
// non-negative IEEE-754 floats bit-pattern order == value order; each
// counting pass is stable, so the result is IDENTICAL to
// std::stable_sort by w (ties keep emission order — the property the
// numpy-backend bit-parity relies on) at ~4-5x the speed on the ~200k
// edges of a 224^2 image (the sort dominates an FH run and the XRAI
// ladder's shared prefix).
void radix_sort_edges(std::vector<Edge>& edges) {
  const size_t n = edges.size();
  if (n < 2) return;
  std::vector<Edge> tmp(n);
  Edge* src = edges.data();
  Edge* dst = tmp.data();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    size_t count[257] = {0};
    for (size_t i = 0; i < n; ++i) {
      uint32_t bits;
      std::memcpy(&bits, &src[i].w, 4);
      ++count[((bits >> shift) & 0xFFu) + 1];
    }
    for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
    for (size_t i = 0; i < n; ++i) {
      uint32_t bits;
      std::memcpy(&bits, &src[i].w, 4);
      dst[count[(bits >> shift) & 0xFFu]++] = src[i];
    }
    std::swap(src, dst);
  }
  // 4 (even) passes: the final swap points src back at edges.data().
}

// 8-connectivity edges (right, down, down-right, down-left), sorted by
// weight. The build + sort is the dominant cost of a run and
// depends only on the (pre-smoothed) image — NOT on scale/min_size — so
// the multi-scale ladder entry point below computes it once per image.
std::vector<Edge> build_sorted_edges(const float* img, int32_t h, int32_t w,
                                     int32_t c) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<Edge> edges;
  edges.reserve(n * 4);

  auto color_dist = [&](int64_t p, int64_t q) -> float {
    float acc = 0.f;
    for (int32_t ch = 0; ch < c; ++ch) {
      const float d = img[p * c + ch] - img[q * c + ch];
      acc += d * d;
    }
    return std::sqrt(acc);
  };

  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t p = static_cast<int64_t>(y) * w + x;
      if (x + 1 < w)
        edges.push_back({color_dist(p, p + 1), (int32_t)p, (int32_t)(p + 1)});
      if (y + 1 < h)
        edges.push_back({color_dist(p, p + w), (int32_t)p, (int32_t)(p + w)});
      if (x + 1 < w && y + 1 < h)
        edges.push_back(
            {color_dist(p, p + w + 1), (int32_t)p, (int32_t)(p + w + 1)});
      if (x > 0 && y + 1 < h)
        edges.push_back(
            {color_dist(p, p + w - 1), (int32_t)p, (int32_t)(p + w - 1)});
    }
  }

  radix_sort_edges(edges);
  return edges;
}

// One (scale, min_size) segmentation over a pre-sorted edge list.
int32_t segment_from_edges(const std::vector<Edge>& edges, int64_t n,
                           float scale, int32_t min_size, int32_t* labels) {
  UnionFind uf(static_cast<int32_t>(n));

  // Pass 1: merge when the edge weight is below both components' adaptive
  // thresholds internal(C) + scale/|C|.
  for (const Edge& e : edges) {
    const int32_t ra = uf.find(e.a);
    const int32_t rb = uf.find(e.b);
    if (ra == rb) continue;
    const float ta = uf.internal[ra] + scale / uf.size[ra];
    const float tb = uf.internal[rb] + scale / uf.size[rb];
    if (e.w <= ta && e.w <= tb) uf.merge(ra, rb, e.w);
  }

  // Pass 2: absorb components smaller than min_size along sorted edges.
  for (const Edge& e : edges) {
    const int32_t ra = uf.find(e.a);
    const int32_t rb = uf.find(e.b);
    if (ra == rb) continue;
    if (uf.size[ra] < min_size || uf.size[rb] < min_size) uf.merge(ra, rb, e.w);
  }

  // Relabel contiguous in raster first-occurrence order.
  std::vector<int32_t> remap(n, -1);
  int32_t next = 0;
  for (int64_t p = 0; p < n; ++p) {
    const int32_t root = uf.find(static_cast<int32_t>(p));
    if (remap[root] < 0) remap[root] = next++;
    labels[p] = remap[root];
  }
  return next;
}

}  // namespace

extern "C" {

// Returns the number of segments written into `labels` (int32 [h*w]).
int32_t felzenszwalb_segment(const float* img, int32_t h, int32_t w, int32_t c,
                             float scale, int32_t min_size, int32_t* labels) {
  const int64_t n = static_cast<int64_t>(h) * w;
  return segment_from_edges(build_sorted_edges(img, h, w, c), n, scale,
                            min_size, labels);
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

// Multi-scale ladder (XRAI's oversegmentation stack): edges built and
// sorted ONCE, then one union-find pass per (scale, min_size). Bit-exact
// with n_scales independent felzenszwalb_segment calls — the per-scale
// result is a pure function of the sorted edge list. Writes labels as
// int32 [n_scales, h*w] and per-scale segment counts into `counts`.
void felzenszwalb_ladder(const float* img, int32_t h, int32_t w, int32_t c,
                         const float* scales, const int32_t* min_sizes,
                         int32_t n_scales, int32_t* labels, int32_t* counts) {
  const int64_t n = static_cast<int64_t>(h) * w;
  const std::vector<Edge> edges = build_sorted_edges(img, h, w, c);
  for (int32_t s = 0; s < n_scales; ++s) {
    counts[s] = segment_from_edges(edges, n, scales[s], min_sizes[s],
                                   labels + static_cast<int64_t>(s) * n);
  }
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
