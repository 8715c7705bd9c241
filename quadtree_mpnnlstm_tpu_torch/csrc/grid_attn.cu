// Stencil attention on the pixel grid on Hopper (sm_90a): kernels K5 and K6.
//
// K5 qtm_grid_attn_fwd replaces the forward of grid_attn_apply (_fwd_kernel)
// of quadtree_mpnnlstm_tpu/ops/pallas_grid_attn.py; K6 qtm_grid_attn_bwd
// replaces its backward (_bwd_rule / _bwd_kernel). On the identity-mapped
// pixelwise mesh every pixel p = r * cols + c of a sample receives one edge
// from each of D = 4 (or 8) static directions (dr, dc): its source is the
// pixel (r - dr, c - dc), when that lies on the grid and both ends are
// valid. Every edge of direction i carries the same edge term e_i = (attr_i
// . We), a row of e (D, H). Per pixel and head h, with scale = 1/sqrt(d):
//
//   logit_i = scale * q[p]_h . (k[src_i]_h + e_i,h)
//   alpha   = softmax over the valid directions (an empty softmax gives 0)
//   out[p]_h = sum_i alpha_i * keep_i,h * (v[src_i]_h + e_i,h)
//
// The TPU kernel tiles row blocks with halo strips so that VMEM holds them
// and reduces heads with one-hot matmuls. Here heads are independent (a
// head's alpha reads only its own d features), so a CTA takes one feature
// group of whole heads (up to 32 features, packing several small heads;
// one head when d > 32) and K5 has two layouts, chosen by the host's plan
// (ops/grid_attn.py fwd_plan) by shape:
//
// K5 row bands (grid_attn_walk_kernel, at d 32: every head of the flagship
// and the MH cells but their 1-feature head convs, H 32, 96, 256 and 768;
// one head a CTA's feature group). A CTA owns a
// strip of W pixel columns and a band of BH rows and walks the band's rows
// top to bottom, as K6 does. Rings in shared memory hold, in their storage
// type, k and v on rows r-1..r+1 (the strip and one side column each way)
// and q on row r; the copies of row r + 1 are in flight (16-byte cp.async,
// zero-filled, not fetched, at masked pixels) while row r computes. A
// thread takes a (column, run of R features) for the whole walk: two
// 16-byte chunks (8 f32 or 16 bf16 features, 4 or 2 lanes a head), its
// copies' addresses computed once. The two chunks of a
// run are stored swapped at every other group of ring columns, so that a
// quarter warp's 16-byte reads fall on distinct bank groups. The edge terms
// are widened once (registers where a thread's D runs fit in 32, else
// shared memory) and the keep values of the directions a thread owns are
// loaded a row ahead into registers. Per row a thread sums its run's
// products of q . (k + e) as a pairwise tree for each direction and an xor
// butterfly over the head's d / R lanes finishes the tree (grid_attn_plain's
// _head_sum order where d divides 32); the lanes share the softmax (lane
// i % lanes takes direction i's exponential and division, shuffles pass
// them on, the denominator sums in direction order); the output sums over
// the directions in order, one 16-byte store a chunk. The sums take every
// direction without a branch: a direction without an edge adds 0 times a
// finite value (its source row is zero-filled), which leaves each sum as
// it was. A band, a row or a warp with no valid pixel stores zeros and does
// no arithmetic. Each k, v and q row is fetched once a band; only the band's
// two edge rows and the strip's two side columns are fetched twice.
//
// K5 pixel tiles (grid_attn_fwd_kernel: every d but 32; the port's paths
// run them at d 1). One CTA per 2-D pixel tile (8 x 32 at d 1; sized by
// the host to the lanes a pixel takes) stages k and v on the tile's
// one-pixel halo, q and keep on the tile, the group's e and the halo's
// validity into f32 shared rows (bf16 rows: loaded, widened and stored by
// the threads, k, v and q in one pass), then each (pixel, head) item takes
// d / RUN lanes (RUN = min(d, 8) where d divides 32; else one lane sums the
// head in feature order, as _head_sum does then). Keeping the tiles at d 1
// is inferred from K6, not measured on K5: at a few features a pixel K6's
// walk lost to its tiles at H 1 (PERF.md), its chain of dependent round
// trips (the band's validity, then the rows it lets through, row after row)
// costing more than one tile's single staging; no K5 walk at d 1 was built.
//
// Both layouts run the softmax two-pass in f32 over the D logits in
// registers, in direction order, and keep products apart from sums (the
// __f*_rn intrinsics): K5 and its plain version agree bit for bit on the
// card, so a 90-step rollout does not drift between them (an online
// softmax once drifted 2.4e-4).
//
// Bound. K5 reads q, k and v at the valid pixels and writes out at every
// pixel (at H 256 on the flagship's grid 212 MB in f32, 106 MB in bf16:
// 0.0634 / 0.0317 ms at 3.35 TB/s) against about 6 D f32 operations a
// (pixel, feature): its bound is bytes. In f32 the walk stays close to its
// bytes: at H 256 its plan reads each k and v row 1.12 times (the band's
// and the strip's halo), q once. In bf16 it is bound by instruction issue
// and latency, not bytes: each (pixel, feature) costs about 25 f32
// operations with products rounded apart and 9 bf16 widenings (q, and k
// and v once a direction), and a variant without the row copies kept most
// of its time (PERF.md). ops/grid_attn.py fwd_plan sizes the strip
// to 128 threads (four CTAs a multiprocessor at <= 128 registers) and the
// bands to one wave of the card; one row in flight beat two to four.
//
// K6 (qtm_grid_attn_bwd) walks row bands, as the TPU kernel walks row
// blocks. Heads are independent (a head's alpha reads only its own d
// features), so a CTA owns a strip of W pixel columns, a band of BH rows
// and one feature group of whole heads (up to 32 features, packing several
// small heads; one head when d > 32), and walks the band's rows top to
// bottom. Rings in shared memory hold k and v on rows r-1..r+2 (the strip
// and two side columns each way) and q, g and the keep planes on rows
// r-1..r+1 (one side column each way), in their storage type; the copies
// of the next kStages rows are in flight (cp.async groups) while a row
// computes. Iteration j:
//   1. the softmax of row j + 1, once per (pixel, head) of the strip and
//      its side columns: a thread sums its run of R features' products in
//      feature order and an xor butterfly over the head's d / R lanes
//      finishes the logit and dalpha_i = keep_i g . (v + e)_i; the lanes
//      share the directions' exponentials and divisions, and the pair
//      (dlogit_i = alpha_i (dalpha_i - rowdot) scale, used_i = alpha_i
//      keep_i) goes to a three-row ring, where rows j - 1..j + 1 are what
//      the outputs of row j read;
//   2. dq, dk, dv of row j: thread (column, run) sums, in direction order,
//      dlogit_i(p) (k + e)_i over the pixel's in-edges and dlogit_i q,
//      used_i g at the destinations of its out-edges, stores its three
//      runs with 16-byte stores and adds the pixel's de terms dlogit_i q +
//      used_i g to its registers.
// A thread's indices (its copies' column and run, its softmax item, its
// output column) are fixed for the walk and computed once. At the end the
// de terms are summed over the strip's columns by a fixed halving tree into
// one partial a CTA, and the last CTA of each feature group to finish (an
// integer counter a group) sums the group's partials in chunks of
// consecutive CTAs, each in order, then the chunks in order: no float
// atomics, so a backward is bit-reproducible, and one launch a call. With single features (d not
// a power-of-two multiple of R, or operands not 16-byte aligned) R is 1,
// one thread takes a (pixel, head) of the softmax, summing its d features
// in order, and one a (pixel, feature) of the outputs.
//
// Order of sums against PR 6's tiles: dq, dk and dv still sum over the
// directions in order; a head's dot products now sum a run in feature
// order before the butterfly (before: strided lanes); de sums a thread's
// rows in order, then the strip's columns, then the CTAs' partials (before:
// a tile's pixels, then the tiles by torch.sum). Products are rounded
// apart from sums (the __f*_rn intrinsics; PR 6 fused them).
//
// Bound and design. K6 reads q, k, v and g and writes dq, dk and dv (28 H
// bytes a pixel in f32, 14 H in bf16) against about 14 H D operations: far
// below the card's operations a byte, so its bound is bytes. PR 6's tiles
// missed it for six reasons, and the walk answers each: staging then
// computing in turn (the rings keep kStages rows in flight while a row
// computes); bf16 widened into f32 shared rows (the rings keep bf16, half
// the room, widened in registers); the softmax recomputed on a 1.56x ring
// (once a pixel, again only on the strip's two side columns and the band's
// two edge rows); masked pixels fetched (zero-filled copies, and rows and
// bands without a valid pixel skip their arithmetic and store zeros);
// scalar stores (16-byte runs); a partial a tile (one a CTA, summed by the
// group's last CTA). What bounds the walk on the card is not bytes but issue
// and latency: a CTA's rows follow one another through two barriers a row,
// and each (pixel, feature) costs about 68 f32 instructions with products
// rounded apart. ops/grid_attn.py bwd_plan sizes the strip to 128 threads
// (four CTAs a multiprocessor at <= 128 registers) and the bands to one
// wave of the card.
//
// Column wrap: a +-1 column shift is checked on the row and the column of
// the source, so it never bleeds across a row end. The kernels take a
// leading batch axis and any heads * d (a head at most kMaxD wide), launch
// on the caller's stream, do not synchronise and allocate nothing; each
// entry point returns cudaGetLastError() (or cudaErrorInvalidValue for a
// geometry it does not take) so that the Python wrapper raises on a
// refused launch.
//
// bf16 (qtm_grid_attn_fwd_bf16, qtm_grid_attn_bwd_bf16; the TPU kernels on
// bf16 q, k, v, e, valid and g): the kernels are templated on the storage
// type T of those and of the outputs out, dq, dk and dv. The K5 and K6
// walks keep bf16 rows as bf16 (widened in registers: half f32's shared
// memory); K5's tiles widen bf16 rows on load
// into the f32 kernel's f32 shared rows (8-byte loads of 4 values, four in
// flight a thread). Every product, sum and the softmax run in f32 in the
// f32 kernels' order, and each output is rounded to bf16 once, on store,
// as the TPU kernel casts its f32 results once. So K5 in bf16 is the f32
// result of its bf16 inputs rounded once, and bit-identical to
// grid_attn_plain's wherever the f32 kernel is. keep and the de partials
// stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// A stored value as f32 (bf16 widens exactly), and an f32 rounded to the
// storage type (bf16: to nearest even, once).
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename S>
__device__ __forceinline__ S from_f(float x) {
  if constexpr (std::is_same<S, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// The two bf16 values of a 32-bit word (the first in the low half) as f32,
// and two f32 rounded to bf16 and packed so.
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf_pack(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

constexpr int kThreads = 256;  // threads of a K5 or K6 CTA
constexpr int kMaxD = 256;     // features of a head
constexpr unsigned kFull = 0xffffffffu;

// Direction i of ops/grid.py SHIFTS_8 (the first four are SHIFTS_4).
__host__ __device__ constexpr int shift_r(int i) {
  return i == 0 ? -1 : i == 1 ? 1 : i < 4 ? 0 : (i % 2 == 0 ? -1 : 1);
}
__host__ __device__ constexpr int shift_c(int i) {
  return i < 2 ? 0 : i == 2 ? -1 : i == 3 ? 1 : i < 6 ? -1 : 1;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;  // 0 source bytes: zero-fill
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ unsigned smem_u32(const void* x) {
  return static_cast<unsigned>(__cvta_generic_to_shared(x));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// Four bf16 values (8 bytes, 8-byte aligned) at x, or zeros when !in; a
// lone bf16 value in the low half when !vec4.
__device__ __forceinline__ uint2 load_bf16(const bf16* x, bool in, bool vec4) {
  if (!in) return make_uint2(0u, 0u);
  if (vec4) return __ldg(reinterpret_cast<const uint2*>(x));
  return make_uint2(__ldg(reinterpret_cast<const unsigned short*>(x)), 0u);
}

// Widen what load_bf16 read into the f32 shared row at dst (16-byte aligned
// when vec4).
__device__ __forceinline__ void store_widened(float* dst, uint2 t, bool vec4) {
  if (vec4)
    *reinterpret_cast<float4*>(dst) = make_float4(bf_lo(t.x), bf_hi(t.x), bf_lo(t.y), bf_hi(t.y));
  else
    *dst = bf_lo(t.x);
}

// Stage K5 tile's rows [f0, f0 + gw) of k and v on the tw-wide halo region
// (n1 pixels, origin (r0 - 1, c0 - 1)) and of q on the tile (nt pixels,
// tc wide, origin (r0, c0)) into f32 rows of stride S; zero outside the
// grid and at masked pixels, whose rows are then not fetched (vld: the
// halo's staged validity). vec4: 4 values a copy (gw, S, H and f0
// multiples of 4, 16-byte aligned tensors). f32 rows go by cp.async
// (16-byte copies at vec4); bf16 rows are loaded, widened and stored by
// the threads (8-byte loads at vec4), the k, v and q copies in one pass
// (one round trip, not two), kBf16Loads copies a thread in flight before
// their stores.
constexpr int kBf16Loads = 4;

template <typename T>
__device__ __forceinline__ void stage_tile(float* ks, float* vs, float* qs, const T* k,
                                           const T* v, const T* q, long long base, int H, int f0,
                                           int gw, int S, int r0, int c0, int tw, int n1, int tc,
                                           int nt, int rows, int cols, bool vec4,
                                           const float* vld) {
  const int step = vec4 ? 4 : 1;
  const int per = gw / step;
  // copy x (k and v on the halo, then, isq, q on the tile): its shared
  // offset (-1 past the regions) and its offset in the tensors
  const auto locate = [&](int x, bool isq, int& dst, long long& at, bool& in) {
    const int y = isq ? x - n1 * per : x;
    const int w = isq ? tc : tw, voff = isq ? 1 : 0;
    const int px = y / per, f = (y - px * per) * step;
    const int r = r0 - 1 + voff + px / w, c = c0 - 1 + voff + px % w;
    dst = y < (isq ? nt : n1) * per ? px * S + f : -1;
    in = dst >= 0 && r >= 0 && r < rows && c >= 0 && c < cols &&
         vld[(px / w + voff) * tw + px % w + voff] != 0.f;
    at = in ? (base + r * cols + c) * H + f0 + f : 0;
  };
  const int total = (n1 + nt) * per;
  if constexpr (std::is_same<T, float>::value) {
    for (int x = threadIdx.x; x < n1 * per; x += kThreads) {  // k and v, then q
      int dst;
      bool in;
      long long at;
      locate(x, false, dst, at, in);
      if (vec4) {
        cp_async16(ks + dst, k + at, in);
        cp_async16(vs + dst, v + at, in);
      } else {
        cp_async4(ks + dst, k + at, in);
        cp_async4(vs + dst, v + at, in);
      }
    }
    for (int x = n1 * per + threadIdx.x; x < total; x += kThreads) {
      int dst;
      bool in;
      long long at;
      locate(x, true, dst, at, in);
      if (vec4)
        cp_async16(qs + dst, q + at, in);
      else
        cp_async4(qs + dst, q + at, in);
    }
  } else {
    for (int x0 = threadIdx.x; x0 < total; x0 += kBf16Loads * kThreads) {
      int dst[kBf16Loads];
      bool isq[kBf16Loads];
      uint2 ta[kBf16Loads], tb[kBf16Loads];
#pragma unroll
      for (int u = 0; u < kBf16Loads; ++u) {  // the loads first, all in flight
        long long at;
        bool in;
        const int x = x0 + u * kThreads;
        isq[u] = x >= n1 * per;
        locate(x, isq[u], dst[u], at, in);
        ta[u] = load_bf16((isq[u] ? q : k) + at, in, vec4);
        tb[u] = load_bf16(v + at, in && !isq[u], vec4);
      }
#pragma unroll
      for (int u = 0; u < kBf16Loads; ++u) {
        if (dst[u] < 0) continue;
        store_widened((isq[u] ? qs : ks) + dst[u], ta[u], vec4);
        if (!isq[u]) store_widened(vs + dst[u], tb[u], vec4);
      }
    }
  }
}

// ---------------------------------------------------------------- K5

// K5's operands; T is the storage type of q, k, v, e, valid and out
template <typename T>
struct FwdParams {
  const T* q;          // (B, P, H)
  const T* k;
  const T* v;
  const T* e;          // (ND, H) per-direction edge terms
  const T* valid;      // (P,) 1 = valid pixel
  const float* keep;   // (B, ND, P, heads) or null (no dropout)
  T* out;              // (B, P, H)
  int rows, cols, heads, d;
  int hpg;             // heads of one CTA's feature group
  int tr, tc;          // tiles: the CTA's pixel tile
  int vec4;            // tiles: stage rows with 16-byte copies
  int strip, band;     // row bands: the CTA's columns (W) and rows (BH)
  int strips;
  float scale;
};

// K5's lane split of a head's d features: each of d / RUN lanes sums a
// run of RUN contiguous features as a pairwise tree, and an xor butterfly
// over those lanes finishes the tree; that is grid_attn_plain's _head_sum
// order when d divides 32. RUN 0: d does not divide 32, and one lane sums
// the d features in order, as _head_sum does then.
__host__ __device__ constexpr int fwd_run(int d) { return 32 % d == 0 ? (d < 8 ? d : 8) : 0; }

// Row stride (floats) of a staged pixel row: with runs of 4 or 8 (float4
// reads) the smallest s >= gw with s % 8 == 4, so that the 8 lanes of a
// quarter warp, on two neighbouring pixels, read 8 distinct 16-byte bank
// groups; else the smallest odd s >= gw, so that lanes on neighbouring
// pixels read distinct banks.
__host__ __device__ constexpr int fwd_stride(int gw, int run) {
  int s = gw;
  while (run >= 4 ? s % 8 != 4 : s % 2 != 1) ++s;
  return s;
}

// Shared-memory floats of one K5 CTA: k and v on the tile's one-pixel
// halo and q on the tile (rows first, 16-byte aligned), the group's edge
// terms, validity on the halo and keep on the tile.
__host__ __device__ inline long long fwd_smem_floats(int nd, int hpg, int d, int tr, int tc) {
  const long long s = fwd_stride(hpg * d, fwd_run(d));
  const long long n1 = static_cast<long long>(tr + 2) * (tc + 2);
  const long long nt = static_cast<long long>(tr) * tc;
  return 2 * n1 * s + nt * s + nd * hpg * d + n1 + nd * nt * hpg;
}

// The pairwise tree over N adjacent values: (x0 + x1) + (x2 + x3), ...
template <int N>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return __fadd_rn(tree_sum<N / 2>(x), tree_sum<N / 2>(x + N / 2));
  }
}

// x[0..N) := src[0..N) from shared memory; float4 reads when N % 4 == 0
// (src 16-byte aligned then).
template <int N>
__device__ __forceinline__ void load_run(const float* src, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + j);
      x[j] = t.x;
      x[j + 1] = t.y;
      x[j + 2] = t.z;
      x[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = src[j];
  }
}

// K5: one CTA per (pixel tile, feature group of whole heads, sample). The
// CTA stages, with cp.async, k and v on the tile's one-pixel halo, q and
// keep on the tile, the group's edge terms and the halo's validity; rows of
// masked pixels are not fetched (no edge reads them). Then every (pixel,
// head) item of the tile takes d / RUN lanes (RUN of fwd_run), each lane a
// run of RUN contiguous features: the D logits (tree over the run, then the
// butterfly), the softmax in direction order, and the lane's run of the
// output, written straight to device memory. Every sum runs in
// grid_attn_plain's order and the __f*_rn intrinsics keep the compiler from
// fusing a product into a sum, so K5 and its plain version agree bit for
// bit. D, HPG, TR and TC fix the head width, the heads of a group and the
// tile at compile time for the flagship's widths; 0 reads them from p.
template <typename T, int ND, int RUN, int D, int HPG, int TR, int TC>
__global__ void __launch_bounds__(kThreads) grid_attn_fwd_kernel(FwdParams<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int d = D ? D : p.d, hpg = HPG ? HPG : p.hpg;
  const int tr = TR ? TR : p.tr, tc = TC ? TC : p.tc;
  const int run = RUN ? RUN : d;       // features a lane
  const int lpi = RUN ? d / RUN : 1;   // lanes an item
  const int H = p.heads * d;
  const int P = p.rows * p.cols;
  const int groups = (p.heads + hpg - 1) / hpg;
  const int grp = blockIdx.x % groups, tile = blockIdx.x / groups;
  const int b = blockIdx.y;
  const int tiles_c = (p.cols + tc - 1) / tc;
  const int r0 = (tile / tiles_c) * tr, c0 = (tile % tiles_c) * tc;
  const int h0 = grp * hpg;
  const int gh = HPG ? HPG : min(hpg, p.heads - h0);  // heads of this group (the last may be ragged)
  const int gw = gh * d, f0 = h0 * d;
  const int S = fwd_stride(hpg * d, RUN);
  const int w1 = tc + 2, n1 = (tr + 2) * w1;  // the one-pixel halo, origin (r0-1, c0-1)
  const int nt = tr * tc;
  float* ks = smem;                           // n1 rows
  float* vs = ks + n1 * S;
  float* qs = vs + n1 * S;                    // nt rows
  float* e_s = qs + nt * S;                   // ND * gw
  float* vld = e_s + ND * hpg * d;            // n1
  float* kps = vld + n1;                      // (ND, nt, hpg) keep
  const long long base = static_cast<long long>(b) * P;

  // ---- stage: validity first, so that masked pixels' rows are skipped
  for (int x = threadIdx.x; x < n1; x += kThreads) {
    const int r = r0 - 1 + x / w1, c = c0 - 1 + x % w1;
    vld[x] = r >= 0 && r < p.rows && c >= 0 && c < p.cols ? to_f(p.valid[r * p.cols + c]) : 0.f;
  }
  for (int x = threadIdx.x; x < ND * gw; x += kThreads)
    e_s[x] = to_f(p.e[(x / gw) * H + f0 + x % gw]);
  if (p.keep != nullptr) {
    for (int x = threadIdx.x; x < ND * nt * gh; x += kThreads) {
      const int i = x / (nt * gh), rest = x - i * nt * gh, px = rest / gh, hh = rest - px * gh;
      const int r = r0 + px / tc, c = c0 + px % tc;
      const bool in = r < p.rows && c < p.cols;
      const long long at =
          in ? ((static_cast<long long>(b) * ND + i) * P + r * p.cols + c) * p.heads + h0 + hh : 0;
      cp_async4(kps + (i * nt + px) * hpg + hh, p.keep + at, in);
    }
  }
  __syncthreads();
  stage_tile<T>(ks, vs, qs, p.k, p.v, p.q, base, H, f0, gw, S, r0, c0, w1, n1, tc, nt, p.rows,
                p.cols, p.vec4, vld);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- one (pixel, head) item per lpi lanes
  const int items = nt * gh;
  const int sub = threadIdx.x % lpi;
  for (int it0 = 0; it0 < items; it0 += kThreads / lpi) {  // uniform across the CTA
    const int it = it0 + threadIdx.x / lpi;
    const bool act = it < items;
    const int px = act ? it / gh : 0, hh = act ? it - px * gh : 0;
    const int ty = px / tc, tx = px - ty * tc;
    const int r = r0 + ty, c = c0 + tx;
    const bool on = act && r < p.rows && c < p.cols;
    const int p1 = (ty + 1) * w1 + tx + 1;
    const bool self_ok = on && vld[p1] != 0.f;
    const int fo = hh * d + sub * run;  // the lane's first feature in the group
    bool has[ND];
    float logit[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int s1 = p1 - shift_r(i) * w1 - shift_c(i);
      has[i] = self_ok && vld[s1] != 0.f;
      float s;
      if constexpr (RUN > 0) {
        float qv[RUN > 0 ? RUN : 1], kv[RUN > 0 ? RUN : 1], ev[RUN > 0 ? RUN : 1];
        load_run<RUN>(qs + px * S + fo, qv);
        load_run<RUN>(ks + s1 * S + fo, kv);
        load_run<RUN>(e_s + i * gw + fo, ev);
#pragma unroll
        for (int j = 0; j < RUN; ++j) qv[j] = __fmul_rn(qv[j], __fadd_rn(kv[j], ev[j]));
        s = tree_sum<RUN>(qv);
        for (int o = 1; o < lpi; o <<= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
      } else {
        s = 0.f;
        if (has[i]) {
          s = __fmul_rn(qs[px * S + fo], __fadd_rn(ks[s1 * S + fo], e_s[i * gw + fo]));
          for (int x = 1; x < d; ++x)
            s = __fadd_rn(s, __fmul_rn(qs[px * S + fo + x],
                                       __fadd_rn(ks[s1 * S + fo + x], e_s[i * gw + fo + x])));
        }
      }
      logit[i] = __fmul_rn(s, p.scale);
    }
    if (!on) continue;  // no shuffle follows
    // softmax over the directions with an edge, in direction order
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (has[i]) mx = fmaxf(mx, logit[i]);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      logit[i] = has[i] ? expf(__fsub_rn(logit[i], mx)) : 0.f;
      den = __fadd_rn(den, logit[i]);
    }
    // out = sum over the directions, in order, of alpha * keep * (v + e);
    // den >= 1 wherever a direction has an edge
    T* o = p.out + (base + r * p.cols + c) * H + f0 + fo;
    if constexpr (RUN > 0) {
      float acc[RUN];
#pragma unroll
      for (int j = 0; j < RUN; ++j) acc[j] = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (!has[i]) continue;
        float used = __fdiv_rn(logit[i], den);
        if (p.keep != nullptr) used = __fmul_rn(used, kps[(i * nt + px) * hpg + hh]);
        const int s1 = p1 - shift_r(i) * w1 - shift_c(i);
        float vv[RUN], ev[RUN];
        load_run<RUN>(vs + s1 * S + fo, vv);
        load_run<RUN>(e_s + i * gw + fo, ev);
#pragma unroll
        for (int j = 0; j < RUN; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(used, __fadd_rn(vv[j], ev[j])));
      }
      if (RUN % 4 == 0 && p.vec4) {
        if constexpr (std::is_same<T, float>::value) {
#pragma unroll
          for (int j = 0; j < RUN; j += 4)
            *reinterpret_cast<float4*>(o + j) = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        } else {  // bf16: 8 bytes a store (o is aligned to the run's 8 or 16 bytes)
#pragma unroll
          for (int j = 0; j < RUN; j += 4)
            *reinterpret_cast<uint2*>(o + j) =
                make_uint2(bf_pack(acc[j], acc[j + 1]), bf_pack(acc[j + 2], acc[j + 3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < RUN; ++j) o[j] = from_f<T>(acc[j]);
      }
    } else {
      float used[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        used[i] = has[i] ? __fdiv_rn(logit[i], den) : 0.f;
        if (has[i] && p.keep != nullptr) used[i] = __fmul_rn(used[i], kps[(i * nt + px) * hpg + hh]);
      }
      for (int x = 0; x < d; ++x) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          if (!has[i]) continue;
          const int s1 = p1 - shift_r(i) * w1 - shift_c(i);
          acc = __fadd_rn(acc, __fmul_rn(used[i], __fadd_rn(vs[s1 * S + fo + x], e_s[i * gw + fo + x])));
        }
        o[x] = from_f<T>(acc);
      }
    }
  }
}

// ---------------------------------------------------------------- row walks

// What the K5 and K6 walks share: shared-memory offsets and a run of R
// values read, written and copied.

__host__ __device__ inline long long up16(long long x) { return (x + 15) / 16 * 16; }

constexpr int kVldLoads = 8;  // validity loads a thread keeps in flight

// A run of R stored values (16 bytes when R > 1) as f32, and R f32 values
// rounded to T and stored as one run.
template <typename T, int R>
__device__ __forceinline__ void load_t(const T* src, float* x) {
  if constexpr (R == 1) {
    x[0] = to_f(*src);
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const uint4 t = *reinterpret_cast<const uint4*>(src);
    x[0] = bf_lo(t.x), x[1] = bf_hi(t.x), x[2] = bf_lo(t.y), x[3] = bf_hi(t.y);
    x[4] = bf_lo(t.z), x[5] = bf_hi(t.z), x[6] = bf_lo(t.w), x[7] = bf_hi(t.w);
  }
}

template <int R>
__device__ __forceinline__ void load_f(const float* src, float (&x)[R]) {
  if constexpr (R % 4 == 0) {
    load_run<R>(src, x);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = src[j];
  }
}

// VG: 16-byte device-memory accesses (the tensors are 16-byte aligned);
// else one value at a time, in the same order of sums.
template <typename T, int R, bool VG>
__device__ __forceinline__ void store_t(T* dst, const float* x) {
  if constexpr (R == 1 || !VG) {
#pragma unroll
    for (int j = 0; j < R; ++j) dst[j] = from_f<T>(x[j]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(bf_pack(x[0], x[1]), bf_pack(x[2], x[3]),
                                                bf_pack(x[4], x[5]), bf_pack(x[6], x[7]));
  }
}

// Copy one run of R values from device memory into shared memory, or zeros
// when !in: 16-byte runs (VG) and f32 values by cp.async (0 source bytes
// zero-fill); bf16 values one at a time by the thread, its loads first.
template <typename T, int R, bool VG>
__host__ __device__ constexpr bool copy_async() {
  return (VG && R * sizeof(T) == 16) || std::is_same<T, float>::value;
}

template <typename T, int R, bool VG>
__device__ __forceinline__ void copy_run(T* dst, const T* src, bool in) {
  if constexpr (VG && R * sizeof(T) == 16) {
    cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), in);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < R; ++j) cp_async4(dst + j, src + j, in);
  } else {
    T t[R];
#pragma unroll
    for (int j = 0; j < R; ++j) t[j] = in ? src[j] : __float2bfloat16_rn(0.f);
#pragma unroll
    for (int j = 0; j < R; ++j) dst[j] = t[j];
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---------------------------------------------------------------- K5 row bands

constexpr int kFwdStages = 1;               // row copies in flight beyond the rows in use
constexpr int kFwdKvSlots = kFwdStages + 3;  // k, v: rows j-1..j+1 in use at row j
constexpr int kFwdQSlots = kFwdStages + 1;   // q: row j

// Byte offsets of one K5 walk CTA's shared memory (ops/grid_attn.py
// walk_smem_bytes mirrors it): the k and v rings (rows of W + 2 pixels) and
// the q ring (W pixels) in the storage type, the group's edge terms (f32),
// the band's validity with its halo and its rows' flags.
struct WalkLayout {
  long long q, e, vl, fl, total;
};

__host__ __device__ inline WalkLayout walk_layout(int nd, int hpg, int d, int itemsize, int w,
                                                  int bh) {
  const long long s = static_cast<long long>(hpg) * d;  // a staged pixel row's values
  WalkLayout l;
  l.q = up16(2LL * kFwdKvSlots * (w + 2) * s * itemsize);
  l.e = l.q + up16(kFwdQSlots * w * s * itemsize);
  l.vl = l.e + up16(4LL * nd * s);
  l.fl = l.vl + up16((bh + 2LL) * (w + 2));
  l.total = l.fl + up16(bh);
  return l;
}

// K5 as a row walk at d 32: one CTA per (strip of W columns and band of BH
// rows, head, sample); a thread takes one (column, run of R features) of the
// strip, a run of two 16-byte chunks (8 f32 or 16 bf16 features), so that a
// head's LANES = 32 / R lanes (4 or 2) sit in one warp and share the
// softmax, lane i % LANES taking direction i. Row j computes with k and v
// rows j - 1 .. j + 1 and q row j in the rings while the rows of j + 1 ..
// j + kFwdStages are in flight. VG: 16-byte device-memory accesses; else
// one value at a time, in the same order of sums.
//
// A run's two chunks are stored in the rings swapped at
// every ring column whose bit fb is set (fb: log2 of the pixels a 128-byte
// bank window holds), so that the eight 16-byte reads of a quarter warp,
// one chunk of each thread's run at neighbouring pixels, fall on eight
// distinct bank groups.
template <typename T, int ND, bool VG>
__global__ void __launch_bounds__(kThreads, 2) grid_attn_walk_kernel(FwdParams<T> p) {
  constexpr int V = 16 / sizeof(T), RC = 2, R = RC * V, LANES = 32 / R;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  unsigned char* smem = walk_smem;
  const int d = p.d, hpg = p.hpg, W = p.strip, BH = p.band;
  const int H = p.heads * d, P = p.rows * p.cols;
  const int b = blockIdx.z, h0 = blockIdx.y * hpg;
  const int gh = min(hpg, p.heads - h0);  // heads of this group (the last may be ragged)
  const int gw = gh * d, f0 = h0 * d;
  const int C0 = (blockIdx.x % p.strips) * W, R0 = (blockIdx.x / p.strips) * BH;
  const int R1 = min(R0 + BH, p.rows);
  const WalkLayout lay = walk_layout(ND, hpg, d, sizeof(T), W, BH);
  const int S = hpg * d, W2 = W + 2;
  T* ks = reinterpret_cast<T*>(smem);  // [kFwdKvSlots][W2][S], columns from C0 - 1
  T* vs = ks + kFwdKvSlots * W2 * S;
  T* qs = reinterpret_cast<T*>(smem + lay.q);  // [kFwdQSlots][W][S], columns from C0
  float* es = reinterpret_cast<float*>(smem + lay.e);  // [ND][S]
  unsigned char* vl = smem + lay.vl;  // [R1 - R0 + 2][W2]: rows from R0 - 1, columns from C0 - 1
  unsigned char* fl = smem + lay.fl;  // rows R0..R1-1: a valid pixel in C0..C0+W-1
  const long long base = static_cast<long long>(b) * P;
  const int tid = threadIdx.x, nt = blockDim.x;
  // the swizzle of a two-chunk run at ring column col
  const int fb = S * static_cast<int>(sizeof(T)) >= 128 ? 0 : S * sizeof(T) == 64 ? 1
               : S * sizeof(T) == 32 ? 2 : 3;
  const auto sw = [&](int col) { return VG ? (col >> fb) & 1 : 0; };

  // ---- the band's validity (0 off the grid; kVldLoads loads a thread in
  // flight), its rows' flags (set by every thread that finds a valid pixel:
  // one value, so no atomics) and the group's edge terms, widened once
  for (int x = tid; x < BH; x += nt) fl[x] = 0;
  for (int x = tid; x < ND * gw; x += nt)
    es[(x / gw) * S + x % gw] = to_f(p.e[(x / gw) * H + f0 + x % gw]);
  __syncthreads();
  const int nv = (R1 - R0 + 2) * W2;
  int any = 0;
  for (int x0 = tid; x0 < nv; x0 += kVldLoads * nt) {
    float val[kVldLoads];
#pragma unroll
    for (int u = 0; u < kVldLoads; ++u) {
      const int x = x0 + u * nt;
      const int r = R0 - 1 + x / W2, c = C0 - 1 + x % W2;
      val[u] = x < nv && r >= 0 && r < p.rows && c >= 0 && c < p.cols
                   ? to_f(p.valid[r * p.cols + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kVldLoads; ++u) {
      const int x = x0 + u * nt;
      if (x >= nv) continue;
      const int rr = x / W2, cc = x % W2;  // row R0 - 1 + rr, column C0 - 1 + cc
      vl[x] = val[u] != 0.f;
      if (val[u] != 0.f && rr >= 1 && rr <= R1 - R0 && cc >= 1 && cc <= W) fl[rr - 1] = 1, any = 1;
    }
  }
  // a thread's (column, run) of the group's pixel rows: the outputs take
  // columns 0..W-1, the copies every column of a row, by steps of cstep
  const int runs = gw / R;
  const int cj = tid % runs, cc0 = tid / runs, cstep = nt / runs;
  const bool cact = cc0 < cstep;
  const bool oact = tid < W * runs && C0 + cc0 < p.cols;
  const int fo = cj * R;  // the thread's first feature in the group
  T* const out = p.out + (base + C0 + cc0) * H + f0 + fo;  // row 0 of the thread's column
  const auto store_run = [&](T* o, const float (&x)[R]) {
    if constexpr (VG) {
#pragma unroll
      for (int h = 0; h < RC; ++h) store_t<T, V, true>(o + h * V, x + h * V);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) o[j] = from_f<T>(x[j]);
    }
  };
  const auto zero_row = [&](int s) {
    if (!oact) return;
    float z[R];
#pragma unroll
    for (int x = 0; x < R; ++x) z[x] = 0.f;
    store_run(out + static_cast<long long>(s) * p.cols * H, z);
  };
  if (!__syncthreads_or(any)) {  // no valid pixel: zeros
    for (int s = R0; s < R1; ++s) zero_row(s);
    return;
  }

  // ---- the row copies: stage r brings q row r and k, v row r + 1 (the
  // first stage rows R0 - 1 .. R0 + 1). With 16-byte accesses (VG) a
  // thread's copies are fixed for the walk, their addresses computed once:
  // the chunks of its run at columns cc0 and cc0 + cstep of a k, v ring row
  // (from C0 - 1) and at column cc0 of a q ring row (from C0), swizzled by
  // ring column; else copy_cols copies value by value.
  const bool ka = cact && cc0 < W2, kb = cact && cc0 + cstep < W2, qa = cact && cc0 < W;
  const unsigned ska = smem_u32(ks + cc0 * S + fo), skb = smem_u32(ks + (cc0 + cstep) * S + fo);
  const unsigned sqa = smem_u32(qs + cc0 * S + fo), vby = smem_u32(vs) - smem_u32(ks);
  const unsigned kvslot_by = W2 * S * sizeof(T), qslot_by = W * S * sizeof(T);
  const long long gka = (base + C0 - 1 + cc0) * H + f0 + fo, gqa = (base + C0 + cc0) * H + f0 + fo;
  const long long gstep = static_cast<long long>(cstep) * H;
  const long long grow = static_cast<long long>(p.cols) * H;
  const int swa = sw(cc0) * 16, swb = sw(cc0 + cstep) * 16;  // a chunk's byte offset, swapped
  const auto copy16 = [](unsigned dst, const T* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 16 : 0));
  };
  // the RC chunks of a run: chunk h to byte (h * 16) ^ swz of the run
  const auto copy_run2 = [&](unsigned dst, const T* src, bool in, int swz) {
#pragma unroll
    for (int h = 0; h < RC; ++h) copy16(dst + ((h * 16) ^ swz), src + (in ? h * V : 0), in);
  };
  // !VG: the thread's run at columns cc0, cc0 + cstep, ... < n of one pixel
  // row (rowat: the offset of column 0's run in src) into a ring row
  const auto copy_cols = [&](T* ring, const T* src, const unsigned char* vrow, long long rowat,
                             int n) {
    for (int px = cc0; cact && px < n; px += cstep) {
      const bool in = vrow[px] != 0;
      copy_run<T, R, false>(ring + px * S + fo,
                            src + (in ? rowat + static_cast<long long>(px) * H : 0), in);
    }
  };
  const auto issue = [&](int r) {
    for (int rr = r == R0 ? R0 - 1 : r + 1; rr <= r + 1; ++rr) {
      const int sl = (rr + 1) % kFwdKvSlots;
      const unsigned char* vrow = vl + (rr - R0 + 1) * W2;
      if constexpr (VG) {
        const long long g = rr * grow;
        if (ka) {
          const bool in = vrow[cc0] != 0;
          const long long at = in ? gka + g : 0;
          copy_run2(ska + sl * kvslot_by, p.k + at, in, swa);
          copy_run2(ska + sl * kvslot_by + vby, p.v + at, in, swa);
        }
        if (kb) {
          const bool in = vrow[cc0 + cstep] != 0;
          const long long at = in ? gka + gstep + g : 0;
          copy_run2(skb + sl * kvslot_by, p.k + at, in, swb);
          copy_run2(skb + sl * kvslot_by + vby, p.v + at, in, swb);
        }
      } else {
        const long long at = (base + rr * p.cols + C0 - 1) * H + f0 + fo;
        copy_cols(ks + sl * W2 * S, p.k, vrow, at, W2);
        copy_cols(vs + sl * W2 * S, p.v, vrow, at, W2);
      }
    }
    if (!fl[r - R0]) return;  // the row stores zeros
    const int sl = r % kFwdQSlots;
    const unsigned char* vrow = vl + (r - R0 + 1) * W2 + 1;  // column C0
    if constexpr (VG) {
      if (qa) {
        const bool in = vrow[cc0] != 0;
        copy_run2(sqa + sl * qslot_by, p.q + (in ? gqa + r * grow : 0), in, sw(cc0) * 16);
      }
    } else {
      copy_cols(qs + sl * W * S, p.q, vrow, (base + r * p.cols + C0) * H + f0 + fo, W);
    }
  };

  // ---- a thread's constants for the walk: its head's lanes, its column's
  // offsets in the rings (column 0 for a thread without an output column)
  // and their swizzles, and the edge terms of its run, widened once, in
  // registers where they fit
  const int sub = cj & (LANES - 1), hh = cj / LANES;
  const int lead = (tid & 31) - sub;  // the head's first lane
  const int ocol = oact ? cc0 : 0;
  const int kvcol = (ocol + 1) * S + fo, qcol = ocol * S + fo;
  const int kvslot = W2 * S, qslot = W * S;
  // a run's chunk h of ring column col + 1 - dc (k, v) or col (q) lies at
  // chunk h ^ swizzle; here the swizzles of columns ocol .. ocol + 2
  int swc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) swc[c] = sw(ocol + c);
  const int swq = sw(ocol);
  const auto load_run2 = [&](const T* src, int swz, float (&x)[R]) {
#pragma unroll
    for (int h = 0; h < RC; ++h) load_t<T, V>(src + (h ^ swz) * V, x + h * V);
  };
  // the keep values of the directions the thread owns in the softmax (the
  // lane's i = t LANES + sub), loaded a row ahead into registers: at a
  // valid pixel, 1 elsewhere
  constexpr int KT = (ND + LANES - 1) / LANES;
  const float* kpix = p.keep == nullptr ? nullptr
      : p.keep + (static_cast<long long>(b) * ND * P + C0 + ocol) * p.heads + h0 + hh;
  const auto load_keep = [&](int r, float (&kv)[KT]) {
    const bool in = kpix != nullptr && r < R1 && vl[(r - R0 + 1) * W2 + ocol + 1] != 0;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int i = t * LANES + sub;
      kv[t] = in && i < ND ? __ldg(kpix + (static_cast<long long>(i) * P + r * p.cols) * p.heads)
                           : 1.f;
    }
  };
  constexpr bool kEReg = ND * R <= 32;
  float ev[kEReg ? ND : 1][R];
  if constexpr (kEReg) {
#pragma unroll
    for (int i = 0; i < ND; ++i) load_run<R>(es + i * S + fo, ev[i]);
  }
  const auto e_run = [&](int i, float (&e)[R]) {
    if constexpr (kEReg) {
#pragma unroll
      for (int x = 0; x < R; ++x) e[x] = ev[i][x];
    } else {
      load_run<R>(es + i * S + fo, e);
    }
  };

  // ---- row j of the thread's column, from k, v rows j - 1 .. j + 1 at
  // kr[0..2], vr[0..2], q at qp, its keep values kp and the validity at vc.
  // Rows are zero-filled at masked pixels and off the grid, so every
  // direction is summed without a branch: a direction without an edge adds
  // used_i = 0 times a finite value, which leaves every sum as it was. The
  // logits (a tree over the run, then the butterfly over the head's lanes),
  // the softmax, the run of the output over the directions in order.
  const auto compute_row = [&](int j, const T* const (&kr)[3], const T* const (&vr)[3],
                               const T* qp, const float (&kp)[KT], const unsigned char* vc) {
    const bool self_ok = oact && *vc != 0;
    T* const o = out + static_cast<long long>(j) * p.cols * H;
    if (!__any_sync(kFull, self_ok)) {  // the warp's pixels are masked
      if (oact) {
        float z[R];
#pragma unroll
        for (int x = 0; x < R; ++x) z[x] = 0.f;
        store_run(o, z);
      }
      return;
    }
    bool has[ND];
    float lg[ND], qv[R];
    load_run2(qp, swq, qv);
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int dr = shift_r(i), dc = shift_c(i);
      has[i] = self_ok && vc[-dr * W2 - dc] != 0;
      float kv[R], e[R];
      load_run2(kr[1 - dr] - dc * S, swc[1 - dc], kv);  // the source (j - dr, c - dc)
      e_run(i, e);
#pragma unroll
      for (int x = 0; x < R; ++x) kv[x] = __fmul_rn(qv[x], __fadd_rn(kv[x], e[x]));
      lg[i] = tree_sum<R>(kv);
    }
#pragma unroll
    for (int o2 = 1; o2 < LANES; o2 <<= 1) {
#pragma unroll
      for (int i = 0; i < ND; ++i) lg[i] = __fadd_rn(lg[i], __shfl_xor_sync(kFull, lg[i], o2));
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      lg[i] = __fmul_rn(lg[i], p.scale);
      if (has[i]) mx = fmaxf(mx, lg[i]);
    }
    // used_i = alpha_i keep_i (0 without an edge); the denominator sums in
    // direction order and is >= 1 wherever a direction has an edge
    float used[ND], den = 0.f;
    // lane sub takes the directions i = sub + t LANES: one exponential and
    // one division a lane for up to LANES directions, passed on to the
    // head's lanes by shuffles
    constexpr int T_ = (ND + LANES - 1) / LANES;
    float ex[T_];
    bool own[T_];
#pragma unroll
    for (int t = 0; t < T_; ++t) {
      float x = 0.f;
      own[t] = false;
#pragma unroll
      for (int i = t * LANES; i < ND && i < (t + 1) * LANES; ++i)
        if (sub == i - t * LANES) x = lg[i], own[t] = has[i];
      ex[t] = own[t] ? expf(__fsub_rn(x, mx)) : 0.f;
#pragma unroll
      for (int i = t * LANES; i < ND && i < (t + 1) * LANES; ++i)
        den = __fadd_rn(den, __shfl_sync(kFull, ex[t], lead + i - t * LANES));
    }
#pragma unroll
    for (int t = 0; t < T_; ++t) {
      float u = 0.f;
      if (own[t]) {
        u = __fdiv_rn(ex[t], den);
        if (p.keep != nullptr) u = __fmul_rn(u, kp[t]);
      }
#pragma unroll
      for (int i = t * LANES; i < ND && i < (t + 1) * LANES; ++i)
        used[i] = __shfl_sync(kFull, u, lead + i - t * LANES);
    }
    if (!oact) return;
    float acc[R];
#pragma unroll
    for (int x = 0; x < R; ++x) acc[x] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      float vv[R], e[R];
      load_run2(vr[1 - shift_r(i)] - shift_c(i) * S, swc[1 - shift_c(i)], vv);
      e_run(i, e);
#pragma unroll
      for (int x = 0; x < R; ++x)
        acc[x] = __fadd_rn(acc[x], __fmul_rn(used[i], __fadd_rn(vv[x], e[x])));
    }
    store_run(o, acc);
  };

  // ---- the walk: the empty rings take stages R0 .. R0 + kFwdStages - 1 at
  // once; then row j waits for stage j and issues stage j + kFwdStages. The
  // slots of rows j - 1 .. j + 1 (k, v) and j (q) turn with j.
#pragma unroll 1
  for (int st = 0; st < kFwdStages; ++st) {
    if (R0 + st < R1) issue(R0 + st);
    cp_async_commit();
  }
  int s0 = R0 % kFwdKvSlots, s1 = (R0 + 1) % kFwdKvSlots, s2 = (R0 + 2) % kFwdKvSlots;
  int sq = R0 % kFwdQSlots;
  float kcur[KT], knext[KT];
  load_keep(R0, kcur);
#pragma unroll 1
  for (int j = R0; j < R1; ++j) {
    cp_async_wait<kFwdStages - 1>();
    __syncthreads();  // stage j landed; every thread is done with row j - 1
    if (j + kFwdStages < R1) issue(j + kFwdStages);
    cp_async_commit();
    load_keep(j + 1, knext);
    if (fl[j - R0]) {  // uniform across the CTA
      const T* const kr[3] = {ks + s0 * kvslot + kvcol, ks + s1 * kvslot + kvcol,
                              ks + s2 * kvslot + kvcol};
      const T* const vr[3] = {vs + s0 * kvslot + kvcol, vs + s1 * kvslot + kvcol,
                              vs + s2 * kvslot + kvcol};
      compute_row(j, kr, vr, qs + sq * qslot + qcol, kcur, vl + (j - R0 + 1) * W2 + ocol + 1);
    } else {
      zero_row(j);
    }
#pragma unroll
    for (int t = 0; t < KT; ++t) kcur[t] = knext[t];
    s0 = s1, s1 = s2, s2 = s2 + 1 == kFwdKvSlots ? 0 : s2 + 1;
    sq = sq + 1 == kFwdQSlots ? 0 : sq + 1;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- K6

// K6's operands; T is the storage type of q, k, v, e, valid, g, dq, dk and dv
template <typename T>
struct BwdParams {
  const T* q;          // (B, P, H)
  const T* k;
  const T* v;
  const T* e;          // (ND, H) per-direction edge terms
  const T* valid;      // (P,) 1 = valid pixel
  const float* keep;   // (B, ND, P, heads) or null (no dropout)
  const T* g;          // the cotangent (B, P, H)
  T* dq;               // (B, P, H)
  T* dk;
  T* dv;
  float* de_part;      // (B, strips * bands, ND, H): one partial a CTA
  T* de;               // (ND, H): the partials' sum
  int* done;           // a counter of finished CTAs a feature group, 0 at rest
  int rows, cols, heads, d;
  int hpg;             // heads of one CTA's feature group
  int strip, band;     // the CTA's columns (W) and rows (BH)
  int strips, bands;
  float scale;
};

constexpr int kStages = 2;             // row copies in flight beyond the rows in use
constexpr int kKvSlots = kStages + 4;  // k, v: rows j-1..j+2 in use at iteration j
constexpr int kQgSlots = kStages + 3;  // q, g, keep: rows j-1..j+1 in use
constexpr int kDlSlots = 3;            // (dlogit, used): rows j-1..j+1

// Elements of a staged pixel row: the group's width; odd for f32 rows of
// single features, so that threads on neighbouring pixels read distinct
// banks (16-byte runs need no pad: a quarter warp reads 128 contiguous
// bytes).
__host__ __device__ inline int bwd_stride(int gw, int run, int itemsize) {
  return run == 1 && itemsize == 4 ? (gw | 1) : gw;
}

// Byte offsets of one K6 CTA's shared memory (ops/grid_attn.py
// bwd_smem_bytes mirrors it): the k/v and q/g row rings (their room reused
// at the end for the de reduction, W x ND x gw f32), the keep ring, the
// group's edge terms (f32), the (dlogit, used) ring, the band's validity
// and its rows' flags, and the de sum's chunks (and the last-CTA flag).
struct BwdLayout {
  long long qg, kp, e, dlu, vl, fl, ch, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int nd, int hpg, int d, int run, int itemsize,
                                                int w, int bh) {
  const int gw = hpg * d;
  const long long s = static_cast<long long>(bwd_stride(gw, run, itemsize)) * itemsize;
  BwdLayout l;
  l.qg = up16(2LL * kKvSlots * (w + 4) * s);
  long long at = l.qg + up16(2LL * kQgSlots * (w + 2) * s);
  at = at > up16(4LL * w * nd * gw) ? at : up16(4LL * w * nd * gw);
  l.kp = at;
  at += up16(4LL * kQgSlots * nd * (w + 2) * hpg);
  l.e = at;
  at += up16(4LL * nd * gw);
  l.dlu = at;
  at += up16(8LL * kDlSlots * (w + 2) * hpg * nd);
  l.vl = at;
  at += up16(static_cast<long long>(bh + 4) * (w + 4));
  l.fl = at;
  at += up16(2LL * (bh + 4));
  l.ch = at;
  at += 4LL * kThreads + 16;
  l.total = at;
  return l;
}

// K6: one CTA per (strip of W columns and band of BH rows, feature group
// of whole heads, sample); R features a thread (16 bytes, or 1). Iteration
// j of the row walk takes the softmax of row j + 1 and the outputs of row
// j, with the rows of iterations j + 1 .. j + kStages in flight. Every
// per-thread index (a copy's column and run, a softmax item, an output
// column and run) is fixed for the walk and computed once.
template <typename T, int ND, int R, bool VG>
__global__ void __launch_bounds__(kThreads, 2) grid_attn_bwd_kernel(BwdParams<T> p) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  unsigned char* smem = bwd_smem;
  const int d = p.d, hpg = p.hpg, W = p.strip, BH = p.band;
  const int H = p.heads * d, P = p.rows * p.cols;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * hpg;
  const int gh = min(hpg, p.heads - h0);  // heads of this group (the last may be ragged)
  const int gw = gh * d, f0 = h0 * d;
  const int C0 = (blockIdx.x % p.strips) * W, R0 = (blockIdx.x / p.strips) * BH;
  const int R1 = min(R0 + BH, p.rows);
  const BwdLayout lay = bwd_layout(ND, hpg, d, R, sizeof(T), W, BH);
  const int S = bwd_stride(hpg * d, R, sizeof(T));
  const int W2 = W + 2, W4 = W + 4;
  T* ks = reinterpret_cast<T*>(smem);  // [kKvSlots][W4][S], columns from C0 - 2
  T* vs = ks + kKvSlots * W4 * S;
  T* qs = reinterpret_cast<T*>(smem + lay.qg);  // [kQgSlots][W2][S], columns from C0 - 1
  T* gs = qs + kQgSlots * W2 * S;
  float* kps = reinterpret_cast<float*>(smem + lay.kp);  // [kQgSlots][ND][W2][hpg]
  float* es = reinterpret_cast<float*>(smem + lay.e);    // [ND][gw]
  float2* dlu = reinterpret_cast<float2*>(smem + lay.dlu);  // [kDlSlots][W2][hpg][ND]
  unsigned char* vl = smem + lay.vl;  // [R1 - R0 + 4][W4]: rows from R0 - 2, columns from C0 - 2
  unsigned char* fsm = smem + lay.fl;  // softmax rows R0-1..R1: a valid pixel in C0-1..C0+W
  unsigned char* fout = fsm + BH + 2;  // output rows R0..R1-1: a valid pixel in C0..C0+W-1
  float* red = reinterpret_cast<float*>(smem);  // [W][ND][gw], after the walk
  const long long base = static_cast<long long>(b) * P;
  const int tid = threadIdx.x, nt = blockDim.x;

  // ---- the band's validity (0 off the grid; kVldLoads loads a thread in
  // flight), its rows' flags (set by every thread that finds a valid
  // pixel: one value, so no atomics) and the edge terms
  for (int x = tid; x < 2 * (BH + 4); x += nt) fsm[x] = 0;
  __syncthreads();
  const int nv = (R1 - R0 + 4) * W4;
  int any_out = 0;
  for (int x0 = tid; x0 < nv; x0 += kVldLoads * nt) {
    float val[kVldLoads];
#pragma unroll
    for (int u = 0; u < kVldLoads; ++u) {
      const int x = x0 + u * nt;
      const int r = R0 - 2 + x / W4, c = C0 - 2 + x % W4;
      val[u] = x < nv && r >= 0 && r < p.rows && c >= 0 && c < p.cols
                   ? to_f(p.valid[r * p.cols + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kVldLoads; ++u) {
      const int x = x0 + u * nt;
      if (x >= nv) continue;
      const int rr = x / W4, cc = x % W4;  // row R0 - 2 + rr, column C0 - 2 + cc
      vl[x] = val[u] != 0.f;
      if (val[u] == 0.f) continue;
      if (rr >= 1 && rr <= R1 - R0 + 2 && cc >= 1 && cc <= W + 2) fsm[rr - 1] = 1;
      if (rr >= 2 && rr < R1 - R0 + 2 && cc >= 2 && cc < W + 2) fout[rr - 2] = 1, any_out = 1;
    }
  }
  for (int x = tid; x < ND * gw; x += nt) es[x] = to_f(p.e[(x / gw) * H + f0 + x % gw]);
  // a thread's (column, run) of the group's pixel rows: the outputs take
  // columns 0..W-1, the copies and the softmax every column of a row, by
  // steps of cstep columns
  const int runs = gw / R;
  const int cj = tid % runs, cc0 = tid / runs, cstep = nt / runs;
  const bool cact = cc0 < cstep;
  const bool oact = tid < W * runs && C0 + cc0 < p.cols;
  const int ohh = cj * R / d, ofo = cj * R;
  const auto zero_row = [&](int s) {
    if (!oact) return;
    float z[R];
#pragma unroll
    for (int x = 0; x < R; ++x) z[x] = 0.f;
    const long long o = (base + s * p.cols + C0 + cc0) * H + f0 + ofo;
    store_t<T, R, VG>(p.dq + o, z);
    store_t<T, R, VG>(p.dk + o, z);
    store_t<T, R, VG>(p.dv + o, z);
  };
  float* part = p.de_part + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * ND * H;
  // d e_dir: the last CTA of the group to finish sums the group's partials
  // in a fixed order (chunks of consecutive CTAs (sample, band, strip),
  // each in order, then the chunks in order) and rounds them once; no
  // float atomics, so a backward is bit-reproducible
  float* chs = reinterpret_cast<float*>(smem + lay.ch);  // kThreads chunk sums
  int* last = reinterpret_cast<int*>(chs + kThreads);
  const auto finish_de = [&]() {
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(p.done + blockIdx.y, 1) == gridDim.x * gridDim.z - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    const int C = ND * gw, n = gridDim.x * gridDim.z;
    const int chunks = C >= nt ? 1 : nt / C, per = (n + chunks - 1) / chunks;
    for (int c0 = 0; c0 < C; c0 += chunks == 1 ? nt : C) {  // uniform across the CTA
      const int c = c0 + (chunks == 1 ? tid : tid % C), k = chunks == 1 ? 0 : tid / C;
      const long long col = (c / gw) * H + f0 + c % gw;
      float acc = 0.f;
      if (c < C && k < chunks) {
        const int end = min(n, (k + 1) * per);
        for (int u = k * per; u < end; ++u)
          acc = __fadd_rn(acc, __ldcg(p.de_part + static_cast<long long>(u) * ND * H + col));
      }
      if (chunks == 1) {
        if (c < C) p.de[col] = from_f<T>(acc);
        continue;
      }
      chs[tid] = acc;
      __syncthreads();
      if (k == 0) {
        float total = chs[c];
        for (int kk = 1; kk < chunks; ++kk) total = __fadd_rn(total, chs[kk * C + c]);
        p.de[col] = from_f<T>(total);
      }
    }
    if (tid == 0) p.done[blockIdx.y] = 0;  // at rest for the next launch
  };
  if (!__syncthreads_or(any_out)) {  // no valid pixel: zero gradients, a zero de partial
    for (int s = R0; s < R1; ++s) zero_row(s);
    for (int x = tid; x < ND * gw; x += nt) part[(x / gw) * H + f0 + x % gw] = 0.f;
    finish_de();
    return;
  }

  // ---- the row copies: stage j brings k, v row j + 2 (the first stage
  // rows R0 - 2 .. R0) and q, g and keep row j + 1; masked pixels and
  // pixels off the grid are zero-filled, not fetched. K5's walk copies its
  // rows by its own code: this lambda as a helper shared with it made K6
  // spill more and run 4 % slower in f32 on an H100.
  const auto stage_pair = [&](const T* a, const T* bb, int r, int c_lo, int n, T* ring_a,
                              T* ring_b) {
    const unsigned char* vrow = vl + (r - R0 + 2) * W4 + c_lo - (C0 - 2);
    const long long rowat = (base + r * p.cols + c_lo) * H + f0 + cj * R;
    if constexpr (copy_async<T, R, VG>() || R > 1) {
      for (int px = cc0; cact && px < n; px += cstep) {
        const bool in = vrow[px] != 0;
        const long long at = in ? rowat + static_cast<long long>(px) * H : 0;
        copy_run<T, R, VG>(ring_a + px * S + cj * R, a + at, in);
        copy_run<T, R, VG>(ring_b + px * S + cj * R, bb + at, in);
      }
    } else {  // single bf16 values: kBf16Loads copies' loads in flight, then their stores
      for (int px0 = cc0; cact && px0 < n; px0 += kBf16Loads * cstep) {
        T ta[kBf16Loads], tb[kBf16Loads];
#pragma unroll
        for (int u = 0; u < kBf16Loads; ++u) {
          const int px = px0 + u * cstep;
          const bool in = px < n && vrow[px] != 0;
          const long long at = in ? rowat + static_cast<long long>(px) * H : 0;
          ta[u] = in ? a[at] : __float2bfloat16_rn(0.f);
          tb[u] = in ? bb[at] : __float2bfloat16_rn(0.f);
        }
#pragma unroll
        for (int u = 0; u < kBf16Loads; ++u) {
          const int px = px0 + u * cstep;
          if (px < n) ring_a[px * S + cj] = ta[u], ring_b[px * S + cj] = tb[u];
        }
      }
    }
  };
  const int kh = tid % gh, kc0 = tid / gh, kstep = nt / gh;  // keep: (column, head)
  const auto issue = [&](int j) {
    for (int r = j == R0 - 2 ? R0 - 2 : j + 2; r <= j + 2; ++r) {
      const int sl = (r + 2) % kKvSlots;
      stage_pair(p.k, p.v, r, C0 - 2, W4, ks + sl * W4 * S, vs + sl * W4 * S);
    }
    const int r = j + 1, sl = (r + 1) % kQgSlots;
    stage_pair(p.q, p.g, r, C0 - 1, W2, qs + sl * W2 * S, gs + sl * W2 * S);
    if (p.keep != nullptr && kc0 < kstep) {
      float* ring = kps + sl * ND * W2 * hpg + kh;
      const unsigned char* vrow = vl + (r - R0 + 2) * W4 + 1;  // column C0 - 1
      const long long rowat =
          (static_cast<long long>(b) * ND * P + r * p.cols + C0 - 1) * p.heads + h0 + kh;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        for (int px = kc0; px < W2; px += kstep) {
          const bool in = vrow[px] != 0;
          const long long at = in ? rowat + (static_cast<long long>(i) * P + px) * p.heads : 0;
          cp_async4(ring + (i * W2 + px) * hpg, p.keep + at, in);
        }
      }
    }
  };

  // ---- the softmax of row r once per (pixel, head) of columns C0-1..C0+W.
  // With 16-byte runs a thread takes a run, a head's d / R lanes finish its
  // sums by the xor butterfly and share its directions' exponentials and
  // divisions. With single features one thread takes a (pixel, head).
  const int lanes = R > 1 ? d / R : 1;
  const int sub = cj % lanes, shh = R > 1 ? cj / lanes : kh;
  const int sc0 = R > 1 ? cc0 : kc0, sstep = R > 1 ? cstep : kstep;
  const bool sact0 = R > 1 ? cact : kc0 < kstep;
  const int sfo = R > 1 ? cj * R : kh * d;  // the thread's first feature
  const int seg = R > 1 ? R : d;
  const auto finish = [&](int r, int cc, int hh, float (&lq)[ND], float (&lg)[ND],
                          const float* krow, float2* out) {
    const unsigned char* vrow = vl + (r - R0 + 2) * W4 + cc + 1;  // column C0 - 1 + cc
    if (*vrow == 0) {
#pragma unroll
      for (int i = 0; i < ND; ++i) out[i] = make_float2(0.f, 0.f);
      return;
    }
    bool has[ND];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      has[i] = vrow[-shift_r(i) * W4 - shift_c(i)] != 0;
      lq[i] = __fmul_rn(lq[i], p.scale);
      if (has[i]) mx = fmaxf(mx, lq[i]);
    }
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      lq[i] = has[i] ? expf(__fsub_rn(lq[i], mx)) : 0.f;
      den = __fadd_rn(den, lq[i]);
    }
    float rowdot = 0.f, kp[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      lq[i] = has[i] ? __fdiv_rn(lq[i], den) : 0.f;  // alpha; den >= 1 where an edge is
      kp[i] = has[i] && p.keep != nullptr ? krow[(i * W2 + cc) * hpg + hh] : 1.f;
      lg[i] = __fmul_rn(lg[i], kp[i]);  // dalpha
      rowdot = __fadd_rn(rowdot, __fmul_rn(lq[i], lg[i]));
    }
#pragma unroll
    for (int i = 0; i < ND; ++i)
      out[i] = make_float2(__fmul_rn(__fmul_rn(lq[i], __fsub_rn(lg[i], rowdot)), p.scale),
                           __fmul_rn(lq[i], kp[i]));
  };
  const auto softmax_row = [&](int r) {
    float2* dl_row = dlu + ((r + 1) % kDlSlots) * W2 * hpg * ND;
    if (r >= p.rows || !fsm[r - R0 + 1]) {  // uniform: no valid pixel on the row
      for (int x = tid; x < W2 * hpg * ND; x += nt) dl_row[x] = make_float2(0.f, 0.f);
      return;
    }
    const int qsl = (r + 1) % kQgSlots;
    const T* qrow = qs + qsl * W2 * S;
    const T* grow = gs + qsl * W2 * S;
    const float* krow = kps + qsl * ND * W2 * hpg;
    const unsigned char* vrow = vl + (r - R0 + 2) * W4 + 1;  // column C0 - 1
    const T* krows[3];
    const T* vrows[3];
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {  // k, v rows r - dr, from column C0 - 2
      const int sl = (r - dr + 2) % kKvSlots;
      krows[dr + 1] = ks + sl * W4 * S;
      vrows[dr + 1] = vs + sl * W4 * S;
    }
    for (int c00 = 0; c00 < W2; c00 += sstep) {  // uniform across the CTA
      const int cc = c00 + sc0;
      const bool act = sact0 && cc < W2;
      const bool self_ok = act && vrow[cc] != 0;
      float lq[ND], lg[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) lq[i] = lg[i] = 0.f;
      if (self_ok) {
        for (int x0 = 0; x0 < seg; x0 += R) {
          float qv[R], gv[R];
          load_t<T, R>(qrow + cc * S + sfo + x0, qv);
          load_t<T, R>(grow + cc * S + sfo + x0, gv);
#pragma unroll
          for (int i = 0; i < ND; ++i) {
            const int at = (cc + 1 - shift_c(i)) * S + sfo + x0;  // source column
            float kv[R], vv[R], ev[R];
            load_t<T, R>(krows[shift_r(i) + 1] + at, kv);
            load_t<T, R>(vrows[shift_r(i) + 1] + at, vv);
            load_f<R>(es + i * gw + sfo + x0, ev);
#pragma unroll
            for (int x = 0; x < R; ++x) {
              lq[i] = __fadd_rn(lq[i], __fmul_rn(qv[x], __fadd_rn(kv[x], ev[x])));
              lg[i] = __fadd_rn(lg[i], __fmul_rn(gv[x], __fadd_rn(vv[x], ev[x])));
            }
          }
        }
      }
      if (lanes == 1) {  // the thread holds the head's sums
        if (act) finish(r, cc, shh, lq, lg, krow, dl_row + (cc * hpg + shh) * ND);
        continue;
      }
      for (int o = 1; o < lanes; o <<= 1) {
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          lq[i] = __fadd_rn(lq[i], __shfl_xor_sync(kFull, lq[i], o));
          lg[i] = __fadd_rn(lg[i], __shfl_xor_sync(kFull, lg[i], o));
        }
      }
      // the head's lanes share the softmax: lane sub takes the directions
      // i = sub, sub + lanes, ... and the shuffles gather what every lane
      // needs, so that the denominator and rowdot sum in direction order
      const int lead = (tid & 31) - sub;  // the head's first lane
      const unsigned char* vcell = vrow + cc;
      bool has[ND];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        has[i] = self_ok && vcell[-shift_r(i) * W4 - shift_c(i)] != 0;
        lq[i] = __fmul_rn(lq[i], p.scale);
        if (has[i]) mx = fmaxf(mx, lq[i]);
      }
      float ex[ND], den = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        ex[i] = i % lanes == sub && has[i] ? expf(__fsub_rn(lq[i], mx)) : 0.f;
        ex[i] = __shfl_sync(kFull, ex[i], lead + i % lanes);
        den = __fadd_rn(den, ex[i]);
      }
      float rowdot = 0.f, kp[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        kp[i] = 1.f;
        float prod = 0.f;
        if (i % lanes == sub && has[i]) {
          ex[i] = __fdiv_rn(ex[i], den);  // alpha; den >= 1 where an edge is
          if (p.keep != nullptr) kp[i] = krow[(i * W2 + cc) * hpg + shh];
          lg[i] = __fmul_rn(lg[i], kp[i]);  // dalpha
          prod = __fmul_rn(ex[i], lg[i]);
        }
        rowdot = __fadd_rn(rowdot, __shfl_sync(kFull, prod, lead + i % lanes));
      }
      if (!act) continue;
      float2* out = dl_row + (cc * hpg + shh) * ND;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (i % lanes != sub) continue;
        out[i] = has[i] ? make_float2(__fmul_rn(__fmul_rn(ex[i], __fsub_rn(lg[i], rowdot)),
                                                p.scale),
                                      __fmul_rn(ex[i], kp[i]))
                        : make_float2(0.f, 0.f);
      }
    }
  };

  // ---- dq, dk, dv of row s: thread (cc0, cj), the directions in order;
  // the pixel's de terms into the thread's registers
  float de[ND][R];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int x = 0; x < R; ++x) de[i][x] = 0.f;
  const int oc = cc0;
  const auto outputs_row = [&](int s) {
    if (!oact) return;
    if (!fout[s - R0] || vl[(s - R0 + 2) * W4 + oc + 2] == 0) {  // a masked pixel has no edge
      zero_row(s);
      return;
    }
    const T* qrows[3];
    const T* grows[3];
    const T* krows[3];
    const float2* drows[3];
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {
      const int qsl = (s + dr + 1) % kQgSlots;  // q, g, (dlogit, used) row s + dr
      qrows[dr + 1] = qs + qsl * W2 * S + ofo;
      grows[dr + 1] = gs + qsl * W2 * S + ofo;
      drows[dr + 1] = dlu + (((s + dr + 1) % kDlSlots) * W2 * hpg + ohh) * ND;
      krows[dr + 1] = ks + ((s - dr + 2) % kKvSlots) * W4 * S + ofo;  // k row s - dr
    }
    float qv[R], gv[R];
    load_t<T, R>(qrows[1] + (oc + 1) * S, qv);
    load_t<T, R>(grows[1] + (oc + 1) * S, gv);
    const float2* mine = drows[1] + (oc + 1) * hpg * ND;
    float dq[R], dk[R], dv[R];
#pragma unroll
    for (int x = 0; x < R; ++x) dq[x] = dk[x] = dv[x] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int dr = shift_r(i), dc = shift_c(i);
      const float2 me = mine[i];
      float kv[R], ev[R], qd[R], gd[R];
      load_t<T, R>(krows[dr + 1] + (oc + 2 - dc) * S, kv);  // the source (s - dr, c - dc)
      load_f<R>(es + i * gw + ofo, ev);
      const int dcol = oc + 1 + dc;  // the destination (s + dr, c + dc)
      load_t<T, R>(qrows[dr + 1] + dcol * S, qd);
      load_t<T, R>(grows[dr + 1] + dcol * S, gd);
      const float2 dst = drows[dr + 1][dcol * hpg * ND + i];
#pragma unroll
      for (int x = 0; x < R; ++x) {
        dq[x] = __fadd_rn(dq[x], __fmul_rn(me.x, __fadd_rn(kv[x], ev[x])));
        dk[x] = __fadd_rn(dk[x], __fmul_rn(dst.x, qd[x]));
        dv[x] = __fadd_rn(dv[x], __fmul_rn(dst.y, gd[x]));
        de[i][x] = __fadd_rn(de[i][x], __fadd_rn(__fmul_rn(me.x, qv[x]), __fmul_rn(me.y, gv[x])));
      }
    }
    const long long o = (base + s * p.cols + C0 + oc) * H + f0 + ofo;
    store_t<T, R, VG>(p.dq + o, dq);
    store_t<T, R, VG>(p.dk + o, dk);
    store_t<T, R, VG>(p.dv + o, dv);
  };

  // ---- the walk: the empty rings take stages R0 - 2 .. R0 + 1 at once
  // (k, v rows R0 - 2 .. R0 + 3: every slot); then iteration j waits for
  // stage j and issues stage j + kStages
#pragma unroll 1
  for (int st = 0; st < kStages + 2; ++st) {
    if (R0 - 2 + st <= R1 - 1) issue(R0 - 2 + st);
    cp_async_commit();
  }
  for (int j = R0 - 2; j < R1; ++j) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // stage j landed; every thread is done with iteration j - 1
    if (j + kStages > R0 + 1 && j + kStages <= R1 - 1) issue(j + kStages);
    cp_async_commit();
    softmax_row(j + 1);
    __syncthreads();  // row j + 1's (dlogit, used) parked
    if (j >= R0) outputs_row(j);
  }

  // ---- de: the threads' terms summed over the strip's columns by a
  // fixed pairwise tree, one partial a CTA
  cp_async_wait<0>();
  __syncthreads();
  if (tid < W * runs) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int x = 0; x < R; ++x) red[(oc * ND + i) * gw + ofo + x] = de[i][x];
  }
  __syncthreads();
  for (int width = W; width > 1;) {  // uniform across the CTA
    const int half = (width + 1) / 2;
    for (int x = tid; x < (width - half) * ND * gw; x += nt) red[x] += red[x + half * ND * gw];
    width = half;
    __syncthreads();
  }
  for (int x = tid; x < ND * gw; x += nt) part[(x / gw) * H + f0 + x % gw] = red[x];
  finish_de();
}

template <typename T, int ND, int RUN, int D, int HPG, int TR, int TC>
cudaError_t launch_fwd(const FwdParams<T>& p, int B, cudaStream_t stream) {
  const int tiles = ((p.rows + p.tr - 1) / p.tr) * ((p.cols + p.tc - 1) / p.tc);
  const dim3 grid(tiles * ((p.heads + p.hpg - 1) / p.hpg), B);
  const size_t smem = sizeof(float) * fwd_smem_floats(ND, p.hpg, p.d, p.tr, p.tc);
  auto* kernel = grid_attn_fwd_kernel<T, ND, RUN, D, HPG, TR, TC>;
  static size_t allowed = 48 * 1024;  // this instance's dynamic shared-memory limit so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The flagship's widths (d 32 one head a group on 8 x 8 tiles; d 1 one head
// on 8 x 32 tiles) take kernels with their geometry fixed at compile time;
// any other geometry the general one of its lane run.
template <typename T, int ND>
cudaError_t launch_fwd_width(const FwdParams<T>& p, int B, cudaStream_t s) {
  if (p.d == 32 && p.hpg == 1 && p.tr == 8 && p.tc == 8)
    return launch_fwd<T, ND, 8, 32, 1, 8, 8>(p, B, s);
  if (p.d == 1 && p.hpg == 1 && p.tr == 8 && p.tc == 32)
    return launch_fwd<T, ND, 1, 1, 1, 8, 32>(p, B, s);
  switch (fwd_run(p.d)) {
    case 8: return launch_fwd<T, ND, 8, 0, 0, 0, 0>(p, B, s);
    case 4: return launch_fwd<T, ND, 4, 0, 0, 0, 0>(p, B, s);
    case 2: return launch_fwd<T, ND, 2, 0, 0, 0, 0>(p, B, s);
    case 1: return launch_fwd<T, ND, 1, 0, 0, 0, 0>(p, B, s);
    default: return launch_fwd<T, ND, 0, 0, 0, 0, 0>(p, B, s);
  }
}

template <typename T, int ND, int R, bool VG>
cudaError_t launch_bwd(const BwdParams<T>& p, int B, int threads, cudaStream_t stream) {
  const dim3 grid(p.strips * p.bands, (p.heads + p.hpg - 1) / p.hpg, B);
  const size_t smem = bwd_layout(ND, p.hpg, p.d, R, sizeof(T), p.strip, p.band).total;
  auto* kernel = grid_attn_bwd_kernel<T, ND, R, VG>;
  static size_t allowed = 48 * 1024;  // this instance's dynamic shared-memory limit so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bad_geometry(int rows, int cols, int heads, int d, int nd, int B) {
  return rows < 1 || cols < 1 || heads < 1 || d < 1 || d > kMaxD ||
         static_cast<long long>(rows) * cols * heads * d > 0x7fffffffLL ||
         (nd != 4 && nd != 8) || B < 0 || B > 65535;
}

template <typename T, int ND, bool VG>
cudaError_t launch_walk(const FwdParams<T>& p, int B, int bands, int threads,
                        cudaStream_t stream) {
  const dim3 grid(p.strips * bands, (p.heads + p.hpg - 1) / p.hpg, B);
  const size_t smem = walk_layout(ND, p.hpg, p.d, sizeof(T), p.strip, p.band).total;
  auto* kernel = grid_attn_walk_kernel<T, ND, VG>;
  static size_t allowed = 48 * 1024;  // this instance's dynamic shared-memory limit so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// walk: K5's row bands (strip, band: a CTA's columns and rows; threads) or
// its pixel tiles (strip, band: the tile's columns and rows; kThreads).
template <typename T>
int grid_attn_fwd(const T* q, const T* k, const T* v, const T* e, const T* valid,
                  const float* keep, T* out, int B, int rows, int cols, int heads, int d, int nd,
                  int walk, int hpg, int strip, int band, int threads, float scale,
                  void* stream) {
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const bool vg = aligned(q) && aligned(k) && aligned(v) && aligned(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = (heads + hpg - 1) / hpg;
  if (bad_geometry(rows, cols, heads, d, nd, B) || hpg < 1 || hpg > heads || strip < 1 ||
      band < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (walk) {
    // d 32, one head a group, runs of two 16-byte chunks
    const int R = 32 / static_cast<int>(sizeof(T));
    const int strips = (cols + strip - 1) / strip, bands = (rows + band - 1) / band;
    if (d != 32 || hpg != 1 || threads < 32 || threads > kThreads ||
        threads % 32 != 0 || strip * (hpg * d / R) > threads ||
        walk_layout(nd, hpg, d, sizeof(T), strip, band).total > 227 * 1024 ||
        static_cast<long long>(strips) * bands > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    FwdParams<T> p{q, k, v, e, valid, keep, out, rows, cols, heads, d, hpg, 0, 0, 0,
                   strip, band, strips, scale};
    cudaError_t err;
    if (vg)
      err = nd == 4 ? launch_walk<T, 4, true>(p, B, bands, threads, s)
                    : launch_walk<T, 8, true>(p, B, bands, threads, s);
    else
      err = nd == 4 ? launch_walk<T, 4, false>(p, B, bands, threads, s)
                    : launch_walk<T, 8, false>(p, B, bands, threads, s);
    return static_cast<int>(err);
  }
  const int tr = band, tc = strip;
  if (threads != kThreads || sizeof(float) * fwd_smem_floats(nd, hpg, d, tr, tc) > 227 * 1024 ||
      static_cast<long long>((rows + tr - 1) / tr) * ((cols + tc - 1) / tc) * groups >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // 4-value row copies and run stores: runs of 4 or 8 features, aligned tensors
  const int vec4 = fwd_run(d) >= 4 && vg;
  const FwdParams<T> p{q, k, v, e, valid, keep, out, rows, cols, heads, d, hpg, tr, tc, vec4,
                       0, 0, 0, scale};
  return static_cast<int>(nd == 4 ? launch_fwd_width<T, 4>(p, B, s)
                                  : launch_fwd_width<T, 8>(p, B, s));
}

template <typename T>
int grid_attn_bwd(const T* q, const T* k, const T* v, const T* e, const T* valid,
                  const float* keep, const T* g, T* dq, T* dk, T* dv, float* de_part, T* de,
                  int* done, int B, int rows, int cols, int heads, int d, int nd, int hpg, int run,
                  int strip, int band, int threads, float scale, void* stream) {
  // run: 16 bytes of features a thread where d takes whole runs and a power
  // of two of them a head, else 1; 16-byte device-memory accesses where
  // every row tensor is 16-byte aligned (the same order of sums either way)
  const int vec = 16 / static_cast<int>(sizeof(T)), lanes = d / vec;
  const bool vec_ok = d % vec == 0 && (lanes & (lanes - 1)) == 0 && lanes <= 32;
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const bool vg = aligned(q) && aligned(k) && aligned(v) && aligned(g) && aligned(dq) &&
                  aligned(dk) && aligned(dv);
  const int gw = hpg * d;
  if (bad_geometry(rows, cols, heads, d, nd, B) || hpg < 1 || hpg > heads ||
      !(run == 1 || (run == vec && vec_ok)) || strip < 1 || band < 1 || threads < 32 ||
      threads > kThreads || threads % 32 != 0 || strip * (gw / run) > threads ||
      bwd_layout(nd, hpg, d, run, sizeof(T), strip, band).total > 227 * 1024 ||
      (heads + hpg - 1) / hpg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int strips = (cols + strip - 1) / strip, bands = (rows + band - 1) / band;
  const BwdParams<T> p{q,  k,  v,       e,  valid, keep, g,    dq,   dk,    dv,     de_part,
                       de, done, rows, cols, heads, d, hpg, strip, band, strips, bands,
                       scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(T);
  cudaError_t err;
  if (run == 1)
    err = nd == 4 ? launch_bwd<T, 4, 1, false>(p, B, threads, s)
                  : launch_bwd<T, 8, 1, false>(p, B, threads, s);
  else if (vg)
    err = nd == 4 ? launch_bwd<T, 4, V, true>(p, B, threads, s)
                  : launch_bwd<T, 8, V, true>(p, B, threads, s);
  else
    err = nd == 4 ? launch_bwd<T, 4, V, false>(p, B, threads, s)
                  : launch_bwd<T, 8, V, false>(p, B, threads, s);
  return static_cast<int>(err);
}

const bf16* in(const void* x) { return static_cast<const bf16*>(x); }
bf16* out(void* x) { return static_cast<bf16*>(x); }

}  // namespace

// walk, hpg, strip, band, threads: K5's plan (ops/grid_attn.py fwd_plan):
// row bands (walk 1) or pixel tiles (0), the heads of a CTA's feature
// group, its columns and rows (a tile's, for tiles) and its threads.
extern "C" int qtm_grid_attn_fwd(const float* q, const float* k, const float* v, const float* e,
                                 const float* valid, const float* keep, float* out, int B,
                                 int rows, int cols, int heads, int d, int nd, int walk, int hpg,
                                 int strip, int band, int threads, float scale, void* stream) {
  return grid_attn_fwd<float>(q, k, v, e, valid, keep, out, B, rows, cols, heads, d, nd, walk,
                              hpg, strip, band, threads, scale, stream);
}

// the same with q, k, v, e, valid and out in bf16 (keep stays f32)
extern "C" int qtm_grid_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* e,
                                      const void* valid, const float* keep, void* o, int B,
                                      int rows, int cols, int heads, int d, int nd, int walk,
                                      int hpg, int strip, int band, int threads, float scale,
                                      void* stream) {
  return grid_attn_fwd<bf16>(in(q), in(k), in(v), in(e), in(valid), keep, out(o), B, rows, cols,
                             heads, d, nd, walk, hpg, strip, band, threads, scale, stream);
}

// hpg: the heads of a CTA's feature group; run, strip, band, threads: its
// features a thread (16 bytes' worth or 1), columns, rows and threads (the
// plan of ops/grid_attn.py bwd_plan); de_part: room for (B, strips *
// bands, nd, H) partials; de: (nd, H), their sum; done: one int a feature
// group, zero, which the kernel leaves zero.
extern "C" int qtm_grid_attn_bwd(const float* q, const float* k, const float* v, const float* e,
                                 const float* valid, const float* keep, const float* g, float* dq,
                                 float* dk, float* dv, float* de_part, float* de, int* done, int B,
                                 int rows, int cols, int heads, int d, int nd, int hpg, int run,
                                 int strip, int band, int threads, float scale, void* stream) {
  return grid_attn_bwd<float>(q, k, v, e, valid, keep, g, dq, dk, dv, de_part, de, done, B, rows,
                              cols, heads, d, nd, hpg, run, strip, band, threads, scale, stream);
}

// the same with q, k, v, e, valid, g, dq, dk, dv and de in bf16 (keep and
// the de partials stay f32)
extern "C" int qtm_grid_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* e,
                                      const void* valid, const float* keep, const void* g,
                                      void* dq, void* dk, void* dv, float* de_part, void* de,
                                      int* done, int B, int rows, int cols, int heads, int d,
                                      int nd, int hpg, int run, int strip, int band, int threads,
                                      float scale, void* stream) {
  return grid_attn_bwd<bf16>(in(q), in(k), in(v), in(e), in(valid), keep, in(g), out(dq),
                             out(dk), out(dv), de_part, out(de), done, B, rows, cols, heads, d,
                             nd, hpg, run, strip, band, threads, scale, stream);
}
