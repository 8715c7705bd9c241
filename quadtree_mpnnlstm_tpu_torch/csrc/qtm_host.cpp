// Host-side graph toolkit of quadtree_mpnnlstm_tpu_torch: the port's own
// copy of the JAX package's native/qtm_host.cpp, the same functions with
// the same results.
//
// Native counterpart of the reference's compiled dependencies: the Numba
// JIT'd split-criterion loops (ref model/graph_functions.py:119-143,
// model/utils.py:7-17) and torch's C++ DataLoader machinery. Used for
// host-side work that feeds the card: one-time static mesh construction,
// dataset preprocessing, and synthetic video generation. Plain C-ABI C++
// bound with ctypes (native_ext.py), built with g++ at first use into
// build/native/.
//
// All functions use caller-allocated buffers and int64 label images with
// -1 = invalid, matching tests/oracle.py semantics.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- quadtree

struct QtParams {
  int64_t rows, cols;
  int64_t max_size;
  double thresh;
  int64_t padding;
  int32_t condition;  // 0 max>, 1 max<, 2 min>, 3 min<
  int32_t has_mask, has_hir;
};

static inline double cell_extreme(const double* img, int64_t hp, int64_t wp,
                                  int64_t r0, int64_t r1, int64_t c0,
                                  int64_t c1, bool want_max) {
  double v = img[r0 * wp + c0];
  for (int64_t r = r0; r < r1; ++r)
    for (int64_t c = c0; c < c1; ++c) {
      double x = img[r * wp + c];
      if (want_max ? (x > v) : (x < v)) v = x;
    }
  return v;
}

static inline bool any_true(const uint8_t* m, int64_t hp, int64_t wp,
                            int64_t r0, int64_t r1, int64_t c0, int64_t c1) {
  for (int64_t r = r0; r < r1; ++r)
    for (int64_t c = c0; c < c1; ++c)
      if (m[r * wp + c]) return true;
  return false;
}

struct QtCtx {
  const QtParams* p;
  const double* img;   // edge-padded (hp, wp)
  const uint8_t* mask; // (hp, wp) or null
  const uint8_t* hir;  // (hp, wp) or null
  int64_t hp, wp;
  int64_t* labels;     // (hp, wp)
  int64_t next_label;
};

static void qt_visit(QtCtx& ctx, int64_t x, int64_t y, int64_t size) {
  const QtParams& p = *ctx.p;
  if (x >= p.rows || y >= p.cols) return;
  if (size == 1) {
    if (ctx.mask && ctx.mask[x * ctx.wp + y]) return;
    ctx.labels[x * ctx.wp + y] = ctx.next_label++;
    return;
  }
  int64_t r0 = std::max<int64_t>(0, x - p.padding);
  int64_t r1 = std::min(x + size + 1 + p.padding, ctx.hp);
  int64_t c0 = std::max<int64_t>(0, y - p.padding);
  int64_t c1 = std::min(y + size + 1 + p.padding, ctx.wp);

  bool want_max = (p.condition == 0 || p.condition == 1);
  double ext = cell_extreme(ctx.img, ctx.hp, ctx.wp, r0, r1, c0, c1, want_max);
  bool split;
  switch (p.condition) {
    case 0: split = ext > p.thresh; break;
    case 1: split = ext < p.thresh; break;
    case 2: split = ext > p.thresh; break;
    default: split = ext < p.thresh; break;
  }
  if (!split && ctx.mask)
    split = any_true(ctx.mask, ctx.hp, ctx.wp, r0, r1, c0, c1);
  if (!split && ctx.hir)
    split = any_true(ctx.hir, ctx.hp, ctx.wp, r0, r1, c0, c1);

  if (split) {
    int64_t h = size / 2;
    qt_visit(ctx, x, y, h);
    qt_visit(ctx, x + h, y, h);
    qt_visit(ctx, x, y + h, h);
    qt_visit(ctx, x + h, y + h, h);
  } else {
    for (int64_t r = x; r < x + size && r < ctx.hp; ++r)
      for (int64_t c = y; c < y + size && c < ctx.wp; ++c)
        ctx.labels[r * ctx.wp + c] = ctx.next_label;
    ctx.next_label++;
  }
}

// img: (rows, cols) row-major float64; mask/hir uint8 or null.
// labels_out: (rows, cols) int64. Returns node count.
int64_t qtm_quadtree_decompose(const QtParams* p, const double* img,
                               const uint8_t* mask, const uint8_t* hir,
                               int64_t* labels_out) {
  int64_t hp = ((p->rows + p->max_size - 1) / p->max_size) * p->max_size;
  int64_t wp = ((p->cols + p->max_size - 1) / p->max_size) * p->max_size;

  // edge-pad image and zero-pad masks (ref graph_functions.py:186-190)
  std::vector<double> imgp(hp * wp);
  for (int64_t r = 0; r < hp; ++r) {
    int64_t rr = std::min(r, p->rows - 1);
    for (int64_t c = 0; c < wp; ++c) {
      int64_t cc = std::min(c, p->cols - 1);
      imgp[r * wp + c] = img[rr * p->cols + cc];
    }
  }
  std::vector<uint8_t> maskp, hirp;
  if (p->has_mask) {
    maskp.assign(hp * wp, 0);
    for (int64_t r = 0; r < p->rows; ++r)
      std::memcpy(&maskp[r * wp], &mask[r * p->cols], p->cols);
  }
  if (p->has_hir) {
    hirp.assign(hp * wp, 0);
    for (int64_t r = 0; r < p->rows; ++r)
      std::memcpy(&hirp[r * wp], &hir[r * p->cols], p->cols);
  }

  std::vector<int64_t> labels(hp * wp, -1);
  QtCtx ctx{p,
            imgp.data(),
            p->has_mask ? maskp.data() : nullptr,
            p->has_hir ? hirp.data() : nullptr,
            hp,
            wp,
            labels.data(),
            0};
  for (int64_t i = 0; i < hp / p->max_size; ++i)
    for (int64_t j = 0; j < wp / p->max_size; ++j)
      qt_visit(ctx, i * p->max_size, j * p->max_size, p->max_size);

  for (int64_t r = 0; r < p->rows; ++r)
    std::memcpy(&labels_out[r * p->cols], &labels[r * wp],
                p->cols * sizeof(int64_t));
  return ctx.next_label;
}

// -------------------------------------------------------------- adjacency

// labels: (rows, cols) int64 with -1 invalid. Emits deduplicated directed
// (src, dst) pairs sorted by (dst, src) — the framework's canonical edge
// order. Returns edge count (capped at cap).
int64_t qtm_adjacency(const int64_t* labels, int64_t rows, int64_t cols,
                      int32_t corners, int64_t* src_out, int64_t* dst_out,
                      int64_t cap) {
  std::vector<std::pair<int64_t, int64_t>> pairs;  // (dst, src)
  pairs.reserve(rows * cols * (corners ? 8 : 4));
  const int64_t dr4[] = {-1, 1, 0, 0, -1, 1, -1, 1};
  const int64_t dc4[] = {0, 0, -1, 1, -1, -1, 1, 1};
  int n_dirs = corners ? 8 : 4;
  for (int64_t r = 0; r < rows; ++r)
    for (int64_t c = 0; c < cols; ++c) {
      int64_t a = labels[r * cols + c];
      if (a < 0) continue;
      for (int d = 0; d < n_dirs; ++d) {
        int64_t rr = r + dr4[d], cc = c + dc4[d];
        if (rr < 0 || rr >= rows || cc < 0 || cc >= cols) continue;
        int64_t b = labels[rr * cols + cc];
        if (b < 0) continue;
        pairs.emplace_back(b, a);  // edge a -> b, keyed (dst=b, src=a)
      }
    }
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  int64_t n = std::min<int64_t>(pairs.size(), cap);
  for (int64_t i = 0; i < n; ++i) {
    dst_out[i] = pairs[i].first;
    src_out[i] = pairs[i].second;
  }
  return (int64_t)pairs.size();
}

// ------------------------------------------------------- moving-mnist gen

// Renders bouncing-sprite videos (parity: ref data/mod_moving_mnist.py
// trajectory/composite/noise semantics) straight into a caller buffer —
// the native data-loader path feeding the input pipeline.
// sprites: (n_sprites, sh, sw) float32 in [0,1].
// out: (n_samples, t_total, canvas, canvas) float32.
void qtm_moving_sprites(const float* sprites, int64_t n_sprites, int64_t sh,
                        int64_t sw, int64_t n_samples, int64_t t_total,
                        int64_t canvas, int64_t n_digits, float pixel_noise,
                        float velocity_noise, uint64_t seed, float* out) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> uni(0.f, 1.f);
  std::normal_distribution<float> vel_noise(0.f, velocity_noise);
  std::normal_distribution<float> pix_noise(0.f, pixel_noise);
  int64_t frame = canvas * canvas;

  for (int64_t s = 0; s < n_samples; ++s) {
    float* vid = out + s * t_total * frame;
    std::fill(vid, vid + t_total * frame, 0.f);
    for (int64_t d = 0; d < n_digits; ++d) {
      const float* spr = sprites + (rng() % n_sprites) * sh * sw;
      float inner_y = (float)(canvas - sh), inner_x = (float)(canvas - sw);
      float y = uni(rng) * inner_y, x = uni(rng) * inner_x;
      float vy = (rng() & 1) ? 1.f : -1.f, vx = (rng() & 1) ? 1.f : -1.f;
      for (int64_t t = 0; t < t_total; ++t) {
        y += vy + (velocity_noise > 0 ? vel_noise(rng) : 0.f);
        x += vx + (velocity_noise > 0 ? vel_noise(rng) : 0.f);
        if (x <= 0) { x = 0; vx = -vx; }
        if (x >= inner_x) { x = inner_x; vx = -vx; }
        if (y <= 0) { y = 0; vy = -vy; }
        if (y >= inner_y) { y = inner_y; vy = -vy; }
        int64_t iy = (int64_t)y, ix = (int64_t)x;
        float* f = vid + t * frame;
        for (int64_t r = 0; r < sh; ++r)
          for (int64_t c = 0; c < sw; ++c) {
            float v = spr[r * sw + c];
            float& dst = f[(iy + r) * canvas + (ix + c)];
            if (v > dst) dst = v;  // max composite (ref :130-132)
          }
      }
    }
    if (pixel_noise > 0)
      for (int64_t i = 0; i < t_total * frame; ++i)
        vid[i] += pix_noise(rng);
  }
}

}  // extern "C"
