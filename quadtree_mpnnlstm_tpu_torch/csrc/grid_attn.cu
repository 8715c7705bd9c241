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
// head's alpha reads only its own d features), so K5 takes one CTA per 2-D
// pixel tile (8 x 8 at d 32, 8 x 32 at d 1; sized by the host to the lanes
// a pixel takes) and one feature group of whole heads (up to 32 features,
// packing several small heads; one head when d > 32). It stages in shared
// memory, with 16-byte cp.async where rows allow, k and v on the tile's
// one-pixel halo (the sources lie at offsets +-1), q and the keep values
// of the tile, the group's slice of e and the halo's validity; rows of
// masked pixels are not fetched. Each (pixel, head) item then takes d / RUN
// lanes, each lane a contiguous run of RUN features (RUN = min(d, 8) when d
// divides 32): the lane sums its run's products as a pairwise tree and an
// xor butterfly over the item's lanes finishes the tree, which is
// grid_attn_plain's _head_sum order; where d does not divide 32 one lane
// sums the head in feature order, as _head_sum does then. The softmax is
// two-pass in f32 over the D logits in registers, in direction order, and
// each lane writes its run of the output with 16-byte stores. Products are
// kept apart from sums (the __f*_rn intrinsics): K5 and its plain version
// agree bit for bit on the card, so a 90-step rollout does not drift
// between them (an online softmax once drifted 2.4e-4).
//
// K6 is one kernel with no float atomics, so a backward is bit-reproducible.
// Heads are independent (a head's alpha reads only its own d features), so
// one CTA takes one 2-D pixel tile (tr x tc, sized by the host to the group
// width) and one feature group of whole heads (up to 32 features, packing
// several small heads; one head when d > 32), and stages in shared memory,
// with cp.async, k and v on the tile's two-pixel halo and q and g on its
// one-pixel ring. Then, all from shared memory:
//   1. per (pixel, head) of the tile and its ring (LPI lanes an item, the
//      lanes splitting the head's d features): recompute alpha as K5 does,
//      dalpha_i = keep_i * g[p] . (v + e)_i, rowdot = sum_i alpha_i *
//      dalpha_i, and park dlogit_i = alpha_i * (dalpha_i - rowdot) * scale
//      and used_i = alpha_i * keep_i (zero where direction i has no edge);
//   2. per (tile pixel, feature): dq[p] = sum_i dlogit_i(p) (k + e)_i over
//      the in-edges, dk[p] = sum_i dlogit_i(p + off_i) q[p + off_i] and
//      dv[p] = sum_i used_i(p + off_i) g[p + off_i] over the out-edges,
//      whose destinations lie on the ring, in direction order;
//   3. with 2., the tile's de_i partial, sum over its pixels of dlogit_i q
//      + used_i g: each thread adds its pixels' terms in order, and the
//      threads' rows are summed by a fixed pairwise tree; the wrapper sums
//      the (tile) partials in a fixed order.
// Each input is read from device memory about once; the halo re-reads of
// neighbouring tiles come from L2. The ring's alphas are recomputed by the
// tiles that share it: (tr + 2)(tc + 2) / (tr tc) of the softmax work.
//
// Bound: both are bound by bytes. K5 reads q, k, v once and writes out
// (16 * H bytes a pixel) against about 6 * H * D operations; K6 reads q, k,
// v and g and writes dq, dk and dv (28 * H bytes a pixel) against about
// 14 * H * D operations: far below the card's 20 operations per byte of
// f32. Each input row is staged once a tile; the halo's re-reads of
// neighbouring tiles' rows come from L2.
//
// Column wrap: a +-1 column shift is checked on the row and the column of
// the source, so it never bleeds across a row end. The kernels take a
// leading batch axis, launch on the caller's stream, do not synchronise and
// allocate nothing; each entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a geometry it does not take) so that the Python
// wrapper raises on a refused launch.
//
// bf16 (qtm_grid_attn_fwd_bf16, qtm_grid_attn_bwd_bf16; the TPU kernels on
// bf16 q, k, v, e, valid and g): both kernels are templated on the storage
// type T of those and of the outputs out, dq, dk and dv. bf16 rows are
// widened on load into the same f32 shared rows as the f32 kernels' (8-byte
// loads of 4 values where the f32 path copies 16 bytes with cp.async, so
// the strides, the tiles and the shared memory are f32's; a thread keeps
// four loads in flight before it stores them, since one dependent load at
// a time cost K6 1.4x f32's time), every product, sum and the softmax run
// in f32 in the f32 kernels' order, and each output is rounded to bf16
// once, on store, as the TPU kernel casts its f32 results once. So K5 in bf16 is the f32 result of its bf16 inputs rounded once,
// and bit-identical to grid_attn_plain's wherever the f32 kernel is. keep
// and the de partials stay f32. The f32 instances are the f32 kernels
// unchanged.

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
constexpr int kMaxH = 256;     // features per pixel
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

// Stage rows [f0, f0 + gw) of a (and of b, unless bs is null) for the
// w-wide pixel region with origin (r0, c0) into f32 rows of stride S; zero
// outside the grid and, where vld is given, at masked pixels, whose rows
// are then not fetched: vld holds the staged validity of a vw-wide region
// whose origin lies voff pixels up and left of (r0, c0). vec4: 4 values a
// copy (gw, S, H and f0 multiples of 4, 16-byte aligned tensors). f32 rows
// go by cp.async (16-byte copies at vec4); bf16 rows are loaded, widened
// and stored by the threads (8-byte loads at vec4), kBf16Loads copies a
// thread in flight before their stores.
constexpr int kBf16Loads = 4;

template <typename T>
__device__ __forceinline__ void stage_rows(float* as, float* bs, const T* a, const T* b,
                                           long long base, int H, int f0, int gw, int S,
                                           int r0, int c0, int w, int n, int rows, int cols,
                                           bool vec4, const float* vld = nullptr, int vw = 0,
                                           int voff = 0) {
  const int step = vec4 ? 4 : 1;
  const int per = gw / step;
  // copy x: its shared offset (-1 past the region) and its offset in a, b
  const auto locate = [&](int x, int& dst, long long& at, bool& in) {
    const int px = x / per, f = (x - px * per) * step;
    const int r = r0 + px / w, c = c0 + px % w;
    dst = x < n * per ? px * S + f : -1;
    in = dst >= 0 && r >= 0 && r < rows && c >= 0 && c < cols &&
         (vld == nullptr || vld[(px / w + voff) * vw + px % w + voff] != 0.f);
    at = in ? (base + r * cols + c) * H + f0 + f : 0;
  };
  if constexpr (std::is_same<T, float>::value) {
    for (int x = threadIdx.x; x < n * per; x += kThreads) {
      int dst;
      long long at;
      bool in;
      locate(x, dst, at, in);
      if (vec4) {
        cp_async16(as + dst, a + at, in);
        if (bs != nullptr) cp_async16(bs + dst, b + at, in);
      } else {
        cp_async4(as + dst, a + at, in);
        if (bs != nullptr) cp_async4(bs + dst, b + at, in);
      }
    }
  } else {
    for (int x0 = threadIdx.x; x0 < n * per; x0 += kBf16Loads * kThreads) {
      int dst[kBf16Loads];
      uint2 ta[kBf16Loads], tb[kBf16Loads];
#pragma unroll
      for (int u = 0; u < kBf16Loads; ++u) {  // the loads first, all in flight
        long long at;
        bool in;
        locate(x0 + u * kThreads, dst[u], at, in);
        ta[u] = load_bf16(a + at, in, vec4);
        tb[u] = bs != nullptr ? load_bf16(b + at, in, vec4) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBf16Loads; ++u) {
        if (dst[u] < 0) continue;
        store_widened(as + dst[u], ta[u], vec4);
        if (bs != nullptr) store_widened(bs + dst[u], tb[u], vec4);
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
  int tr, tc;          // the CTA's pixel tile
  int vec4;            // stage rows with 16-byte copies
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
  stage_rows<T>(ks, vs, p.k, p.v, base, H, f0, gw, S, r0 - 1, c0 - 1, w1, n1, p.rows, p.cols,
             p.vec4, vld, w1, 0);
  stage_rows<T>(qs, nullptr, p.q, nullptr, base, H, f0, gw, S, r0, c0, tc, nt, p.rows, p.cols,
             p.vec4, vld, w1, 1);
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
  float* de_part;      // (B, tiles, ND, H): one partial a (tile, feature group)
  int rows, cols, heads, d;
  int hpg;             // heads of one CTA's feature group
  int tr, tc;          // the CTA's pixel tile
  int vec4;            // stage rows with 16-byte copies
  float scale;
};

// Lanes that share one (pixel, head) item of K6's softmax phase.
__host__ __device__ constexpr int bwd_lpi(int d) { return d >= 4 ? 4 : d >= 2 ? 2 : 1; }

// Row stride (floats) of a staged pixel row in shared memory: the smallest
// s >= gw with s % (2 lpi) == lpi, so that the lpi lanes of the items of one
// warp, each on its own pixel and reading features sub, sub + lpi, ..., hit
// distinct banks; at lpi 4 it is a multiple of 4, so rows take 16-byte copies.
__host__ __device__ constexpr int smem_stride(int gw, int lpi) {
  int s = gw;
  while (s % (2 * lpi) != lpi) ++s;
  return s;
}

// Shared-memory floats of one K6 CTA: k and v on the tile's two-pixel halo,
// q and g on its one-pixel ring (rows first, 16-byte aligned), the group's
// edge terms, validity on the halo, keep, dlogit and used on the ring, and
// the threads' de terms.
__host__ __device__ inline long long bwd_smem_floats(int nd, int hpg, int d, int tr, int tc) {
  const long long s = smem_stride(hpg * d, bwd_lpi(d));
  const long long n2 = static_cast<long long>(tr + 4) * (tc + 4);
  const long long n1 = static_cast<long long>(tr + 2) * (tc + 2);
  return 2 * n2 * s + 2 * n1 * s + nd * hpg * d + n2 + 3LL * nd * n1 * hpg + nd * kThreads;
}

// K6: one CTA per (pixel tile, feature group of whole heads, sample). LPI
// lanes share one (pixel, head) item of the softmax phase. D, HPG, TR and
// TC fix the head width, the heads of a group and the tile at compile time
// for the flagship's widths, so that the index arithmetic folds; 0 reads
// them from p (any geometry, a ragged last group included).
template <typename T, int ND, int LPI, int D, int HPG, int TR, int TC>
__global__ void __launch_bounds__(kThreads) grid_attn_bwd_kernel(BwdParams<T> p) {
  extern __shared__ float smem[];
  const int d = D ? D : p.d, hpg = HPG ? HPG : p.hpg;
  const int tr = TR ? TR : p.tr, tc = TC ? TC : p.tc;
  const int H = p.heads * d;
  const int P = p.rows * p.cols;
  const int b = blockIdx.z;
  const int tiles_c = (p.cols + tc - 1) / tc;
  const int r0 = (blockIdx.x / tiles_c) * tr, c0 = (blockIdx.x % tiles_c) * tc;
  const int h0 = blockIdx.y * hpg;
  const int gh = HPG ? HPG : min(hpg, p.heads - h0);  // heads of this group (the last may be ragged)
  const int gw = gh * d, f0 = h0 * d;
  const int S = smem_stride(gw, LPI), smax = smem_stride(hpg * d, LPI);
  const int w2 = tc + 4, n2 = (tr + 4) * w2;  // the two-pixel halo, origin (r0-2, c0-2)
  const int w1 = tc + 2, n1 = (tr + 2) * w1;  // the one-pixel ring, origin (r0-1, c0-1)
  float* ks = smem;                           // n2 rows
  float* vs = ks + n2 * smax;
  float* qs = vs + n2 * smax;                 // n1 rows
  float* gs = qs + n1 * smax;
  float* e_s = gs + n1 * smax;                // ND * gw
  float* vld = e_s + ND * hpg * d;            // n2
  float* kps = vld + n2;                      // (ND, n1, hpg) keep
  float* dls = kps + ND * n1 * hpg;           // (ND, n1, hpg) dlogit * scale
  float* uss = dls + ND * n1 * hpg;           // (ND, n1, hpg) alpha * keep
  float* red = uss + ND * n1 * hpg;           // ND * kThreads: the de terms
  const long long base = static_cast<long long>(b) * P;

  // ---- stage: every operand of the tile is read from device memory once
  stage_rows<T>(ks, vs, p.k, p.v, base, H, f0, gw, S, r0 - 2, c0 - 2, w2, n2, p.rows, p.cols,
             p.vec4);
  stage_rows<T>(qs, gs, p.q, p.g, base, H, f0, gw, S, r0 - 1, c0 - 1, w1, n1, p.rows, p.cols,
             p.vec4);
  if (p.keep != nullptr) {
    for (int x = threadIdx.x; x < ND * n1 * gh; x += kThreads) {
      const int i = x / (n1 * gh), rest = x - i * n1 * gh, px = rest / gh, hh = rest - px * gh;
      const int r = r0 - 1 + px / w1, c = c0 - 1 + px % w1;
      const bool in = r >= 0 && r < p.rows && c >= 0 && c < p.cols;
      const long long at =
          in ? ((static_cast<long long>(b) * ND + i) * P + r * p.cols + c) * p.heads + h0 + hh : 0;
      cp_async4(kps + (i * n1 + px) * hpg + hh, p.keep + at, in);
    }
  }
  for (int x = threadIdx.x; x < ND * gw; x += kThreads)
    e_s[x] = to_f(p.e[(x / gw) * H + f0 + x % gw]);
  for (int x = threadIdx.x; x < n2; x += kThreads) {
    const int r = r0 - 2 + x / w2, c = c0 - 2 + x % w2;
    vld[x] = r >= 0 && r < p.rows && c >= 0 && c < p.cols ? to_f(p.valid[r * p.cols + c]) : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- softmax phase: alpha, dlogit and used once per (pixel, head,
  // direction) of the tile and its ring (zero where there is no edge)
  const int items = n1 * gh;
  const int sub = threadIdx.x % LPI;
  for (int it0 = 0; it0 < items; it0 += kThreads / LPI) {  // uniform across the CTA
    const int it = it0 + threadIdx.x / LPI;
    const bool act = it < items;
    const int px = act ? it / gh : 0, hh = act ? it - px * gh : 0;
    const int rr = px / w1, cc = px - rr * w1;
    const int p2 = (rr + 1) * w2 + cc + 1;
    const bool self_ok = act && vld[p2] != 0.f;
    float lq[ND], lg[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      lq[i] = 0.f;
      lg[i] = 0.f;
    }
    if (self_ok) {
      const int fo = hh * d;
#pragma unroll 4
      for (int x = sub; x < d; x += LPI) {
        const float fq = qs[px * S + fo + x], fg = gs[px * S + fo + x];
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          const int s2 = p2 - shift_r(i) * w2 - shift_c(i);
          const float ek = e_s[i * gw + fo + x];
          lq[i] = fmaf(fq, ks[s2 * S + fo + x] + ek, lq[i]);
          lg[i] = fmaf(fg, vs[s2 * S + fo + x] + ek, lg[i]);
        }
      }
    }
#pragma unroll
    for (int o = LPI / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        lq[i] += __shfl_xor_sync(kFull, lq[i], o);
        lg[i] += __shfl_xor_sync(kFull, lg[i], o);
      }
    bool has[ND];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      has[i] = self_ok && vld[p2 - shift_r(i) * w2 - shift_c(i)] != 0.f;
      lq[i] *= p.scale;
      if (has[i]) mx = fmaxf(mx, lq[i]);
    }
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      lq[i] = has[i] ? expf(lq[i] - mx) : 0.f;
      den += lq[i];
    }
    float rowdot = 0.f, kp[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      lq[i] = has[i] && den != 0.f ? lq[i] / den : 0.f;  // alpha
      kp[i] = has[i] && p.keep != nullptr ? kps[(i * n1 + px) * hpg + hh] : 1.f;
      lg[i] *= kp[i];  // dalpha
      rowdot = fmaf(lq[i], lg[i], rowdot);
    }
    if (act && sub == 0) {
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int at = (i * n1 + px) * hpg + hh;
        dls[at] = lq[i] * (lg[i] - rowdot) * p.scale;
        uss[at] = lq[i] * kp[i];
      }
    }
  }
  __syncthreads();

  // ---- dq, dk, dv of the tile's pixels (dq over the pixel's in-edges,
  // dk and dv over its out-edges, whose destinations lie on the ring) and
  // the tile's de partial: thread (g, f) keeps feature f of the pixels g,
  // g + pstep, ... and adds their de terms in that order
  const int n_t = tr * tc;
  const int pstep = kThreads / gw;
  const int f = threadIdx.x % gw, g = threadIdx.x / gw, hh = f / d;
  float de[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) de[i] = 0.f;
  for (int pt = g; g < pstep && pt < n_t; pt += pstep) {
    const int ty = pt / tc, tx = pt - ty * tc;
    const int r = r0 + ty, c = c0 + tx;
    if (r >= p.rows || c >= p.cols) continue;
    const int p1 = (ty + 1) * w1 + tx + 1, p2 = (ty + 2) * w2 + tx + 2;
    const float qf = qs[p1 * S + f], gf = gs[p1 * S + f];
    float dq = 0.f, dk = 0.f, dv = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int s2 = p2 - shift_r(i) * w2 - shift_c(i);
      const int d1 = p1 + shift_r(i) * w1 + shift_c(i);
      const float dl = dls[(i * n1 + p1) * hpg + hh];
      dq = fmaf(dl, ks[s2 * S + f] + e_s[i * gw + f], dq);
      dk = fmaf(dls[(i * n1 + d1) * hpg + hh], qs[d1 * S + f], dk);
      dv = fmaf(uss[(i * n1 + d1) * hpg + hh], gs[d1 * S + f], dv);
      de[i] = fmaf(dl, qf, fmaf(uss[(i * n1 + p1) * hpg + hh], gf, de[i]));
    }
    const long long o = (base + r * p.cols + c) * H + f0 + f;
    p.dq[o] = from_f<T>(dq);
    p.dk[o] = from_f<T>(dk);
    p.dv[o] = from_f<T>(dv);
  }
  // the pstep rows of (ND, gw) de terms, summed by a fixed pairwise tree
  if (g < pstep) {
#pragma unroll
    for (int i = 0; i < ND; ++i) red[(g * ND + i) * gw + f] = de[i];
  }
  __syncthreads();
  for (int width = pstep; width > 1;) {  // uniform across the CTA
    const int half = (width + 1) / 2;
    for (int x = threadIdx.x; x < (width - half) * ND * gw; x += kThreads)
      red[x] += red[x + half * ND * gw];
    width = half;
    __syncthreads();
  }
  float* part = p.de_part + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * ND * H;
  for (int x = threadIdx.x; x < ND * gw; x += kThreads)
    part[(x / gw) * H + f0 + x % gw] = red[x];
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

template <typename T, int ND, int LPI, int D, int HPG, int TR, int TC>
cudaError_t launch_bwd(const BwdParams<T>& p, int B, cudaStream_t stream) {
  const int tiles = ((p.rows + p.tr - 1) / p.tr) * ((p.cols + p.tc - 1) / p.tc);
  const dim3 grid(tiles, (p.heads + p.hpg - 1) / p.hpg, B);
  const size_t smem = sizeof(float) * bwd_smem_floats(ND, p.hpg, p.d, p.tr, p.tc);
  auto* kernel = grid_attn_bwd_kernel<T, ND, LPI, D, HPG, TR, TC>;
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
// any other geometry the general one.
template <typename T, int ND>
cudaError_t launch_bwd_width(const BwdParams<T>& p, int B, cudaStream_t s) {
  if (p.d == 32 && p.hpg == 1 && p.tr == 8 && p.tc == 8)
    return launch_bwd<T, ND, 4, 32, 1, 8, 8>(p, B, s);
  if (p.d == 1 && p.hpg == 1 && p.tr == 8 && p.tc == 32)
    return launch_bwd<T, ND, 1, 1, 1, 8, 32>(p, B, s);
  switch (bwd_lpi(p.d)) {
    case 4: return launch_bwd<T, ND, 4, 0, 0, 0, 0>(p, B, s);
    case 2: return launch_bwd<T, ND, 2, 0, 0, 0, 0>(p, B, s);
    default: return launch_bwd<T, ND, 1, 0, 0, 0, 0>(p, B, s);
  }
}

bool bad_geometry(int rows, int cols, int heads, int d, int nd, int B) {
  return rows < 1 || cols < 1 || heads < 1 || d < 1 || heads * d > kMaxH ||
         (nd != 4 && nd != 8) || B < 0 || B > 65535;
}

template <typename T>
int grid_attn_fwd(const T* q, const T* k, const T* v, const T* e, const T* valid,
                  const float* keep, T* out, int B, int rows, int cols, int heads, int d, int nd,
                  int hpg, int tr, int tc, float scale, void* stream) {
  if (bad_geometry(rows, cols, heads, d, nd, B) || hpg < 1 || hpg > heads || tr < 1 || tc < 1 ||
      sizeof(float) * fwd_smem_floats(nd, hpg, d, tr, tc) > 227 * 1024 ||
      static_cast<long long>((rows + tr - 1) / tr) * ((cols + tc - 1) / tc) *
              ((heads + hpg - 1) / hpg) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // 4-value row copies and run stores: runs of 4 or 8 features, aligned tensors
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const int vec4 = fwd_run(d) >= 4 && aligned(q) && aligned(k) && aligned(v) && aligned(out);
  const FwdParams<T> p{q, k, v, e, valid, keep, out, rows, cols, heads, d, hpg, tr, tc, vec4,
                       scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nd == 4 ? launch_fwd_width<T, 4>(p, B, s)
                                  : launch_fwd_width<T, 8>(p, B, s));
}

template <typename T>
int grid_attn_bwd(const T* q, const T* k, const T* v, const T* e, const T* valid,
                  const float* keep, const T* g, T* dq, T* dk, T* dv, float* de_part, int B,
                  int rows, int cols, int heads, int d, int nd, int hpg, int tr, int tc,
                  float scale, void* stream) {
  if (bad_geometry(rows, cols, heads, d, nd, B) || hpg < 1 || hpg > heads || tr < 1 || tc < 1 ||
      sizeof(float) * bwd_smem_floats(nd, hpg, d, tr, tc) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // 4-value row copies: whole 4-value chunks, 16-byte aligned tensors
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const int vec4 = d % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(g);
  const BwdParams<T> p{q, k, v, e, valid, keep, g, dq, dk, dv, de_part,
                       rows, cols, heads, d, hpg, tr, tc, vec4, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nd == 4 ? launch_bwd_width<T, 4>(p, B, s)
                                  : launch_bwd_width<T, 8>(p, B, s));
}

const bf16* in(const void* x) { return static_cast<const bf16*>(x); }
bf16* out(void* x) { return static_cast<bf16*>(x); }

}  // namespace

// hpg, tr, tc: the feature group (whole heads) and pixel tile of one CTA.
extern "C" int qtm_grid_attn_fwd(const float* q, const float* k, const float* v, const float* e,
                                 const float* valid, const float* keep, float* out, int B,
                                 int rows, int cols, int heads, int d, int nd, int hpg, int tr,
                                 int tc, float scale, void* stream) {
  return grid_attn_fwd<float>(q, k, v, e, valid, keep, out, B, rows, cols, heads, d, nd, hpg, tr,
                              tc, scale, stream);
}

// the same with q, k, v, e, valid and out in bf16 (keep stays f32)
extern "C" int qtm_grid_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* e,
                                      const void* valid, const float* keep, void* o, int B,
                                      int rows, int cols, int heads, int d, int nd, int hpg,
                                      int tr, int tc, float scale, void* stream) {
  return grid_attn_fwd<bf16>(in(q), in(k), in(v), in(e), in(valid), keep, out(o), B, rows, cols,
                             heads, d, nd, hpg, tr, tc, scale, stream);
}

// hpg, tr, tc: the feature group (whole heads) and pixel tile of one CTA;
// de_part holds (B, tiles, nd, H) partials, tiles = ceil(rows/tr) * ceil(cols/tc).
extern "C" int qtm_grid_attn_bwd(const float* q, const float* k, const float* v, const float* e,
                                 const float* valid, const float* keep, const float* g, float* dq,
                                 float* dk, float* dv, float* de_part, int B, int rows, int cols,
                                 int heads, int d, int nd, int hpg, int tr, int tc, float scale,
                                 void* stream) {
  return grid_attn_bwd<float>(q, k, v, e, valid, keep, g, dq, dk, dv, de_part, B, rows, cols,
                              heads, d, nd, hpg, tr, tc, scale, stream);
}

// the same with q, k, v, e, valid, g, dq, dk and dv in bf16 (keep and the
// de partials stay f32)
extern "C" int qtm_grid_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* e,
                                      const void* valid, const float* keep, const void* g,
                                      void* dq, void* dk, void* dv, float* de_part, int B,
                                      int rows, int cols, int heads, int d, int nd, int hpg,
                                      int tr, int tc, float scale, void* stream) {
  return grid_attn_bwd<bf16>(in(q), in(k), in(v), in(e), in(valid), keep, in(g), out(dq),
                             out(dk), out(dv), de_part, B, rows, cols, heads, d, nd, hpg, tr, tc,
                             scale, stream);
}
