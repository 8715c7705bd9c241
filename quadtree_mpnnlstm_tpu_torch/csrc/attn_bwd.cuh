// K4 of the fused TransformerConv aggregation on Hopper (sm_90a): the
// backward of K3 (attn.cuh), in two kernels. Included by attn_bwd.cu and
// attn_bwd_bf16.cu, its f32 and bf16 entry points.
//
// K4 (qtm_attn_bwd; attn_bwd_kernel, then attn_bwd_src_kernel) replaces
// the backward of attn_apply (_attn_bwd / _bwd_kernel,
// quadtree_mpnnlstm_tpu/ops/pallas_attn.py, pallas_call at :424). Per
// destination n, head h and its slots j (alpha the softmax of the logits,
// dalpha_j = keep_j * g[n] . (v + e)_j, rowdot = sum_j alpha_j dalpha_j):
//
//   dlogit_j = alpha_j * (dalpha_j - rowdot),  dlog_j = dlogit_j * scale
//   dq[n]  = sum_j dlog_j (k + e)_j
//   dk[s]  = sum_{j: src_j = s} dlog_j q[dst_j]
//   dv[s]  = sum_{j: src_j = s} alpha_j keep_j g[dst_j]
//   dWe    = sum_j attr_j (x) (dlog_j q[dst_j] + used_j g[dst_j]),  used_j = alpha_j keep_j
//
// Its residuals are K3's inputs (q, k, v, We, keep and the windows): alpha
// is recomputed, no log-sum-exp or output is saved. K4 is bound by bytes:
// per live slot it reads a k and a v row and, per source slot, a q and a g
// row (about 8 * HD bytes in f32) against about 4*A*HD + 11*HD operations,
// about one operation a byte where the card needs 20 (f32) or 295 (bf16,
// tensor cores) before operations bound it. So its levers are the bytes
// and the loads in flight, and wgmma was weighed and rejected: a slot's
// products are HD-long dot products and axpys of one row each, with no
// tile of rows sharing an operand to feed a 64-row matrix product, and the
// tensor cores would shorten only the arithmetic, which is not the bound.
// The design:
//   - The first kernel (per destination) takes K3's layout: persistent CTAs
//     over (32-row group, slice of heads) units, tile-major, the grid sized
//     by occupancy (cached per instance); the tile's windows staged with
//     16-byte cp.async and each row's slot range found by ballot
//     (group_starts); lanes over heads, lanes_head lanes a head and a run
//     of F contiguous features a lane read as 16-byte vectors (ops/attn.py
//     bwd_plan: 4 f32 or 8 bf16 values), so that narrow rows pack a warp
//     (HD 16: 8 rows in f32, 16 in bf16; HD 1: 32) and no lane idles at
//     HD 16 or 1; wide rows take runs that put two rows in a warp (HD 256:
//     16 lanes a row) or slices of heads that keep four slots in flight (24
//     heads x d 16: two slices). A CTA serves one slice of heads, so each
//     lane's columns are fixed for its life.
//   - Each slot's k and v are read once: a chunk of C slots' k and v runs
//     and keep values are loaded into registers before any arithmetic
//     (bwd_load; the first chunk's with the row's q and g); from them the
//     logits and dalpha (bwd_logits: their head sums by an xor butterfly in
//     registers, no shared buffer); then max, denominator and rowdot online
//     over the chunks, exp2f once a (slot, head) in log2 units; then alpha,
//     dlog, used and dq from the same registers, the last chunk first. Only
//     rows longer than a chunk read their earlier chunks a second time.
//   - The edge term is folded as in K3: q . (k + e) = q . k + sum_a attr_a
//     (q . We_a), likewise g . (v + e); dq = sum_j dlog_j k_j + sum_a ad_a
//     We_a with ad_a = sum_j dlog_j attr_ja; a row's dWe terms are q[n] ad_a
//     + g[n] au_a (au_a = sum_j used_j attr_ja), added once a row to the
//     lane's registers. At the end a CTA sums the lanes that share a column
//     in (warp, item) order into its dWe partial, and the second kernel's
//     last CTAs sum the partials in CTA order.
//   - dlog and used are parked per (slot, head) (4 bytes each, not an
//     HD-wide row) for the second kernel, owner-computes over the
//     source-sorted slot view that the graph builds once per mesh
//     (ops/attn.py slot_view): the lanes of (source s, slice) gather dk and
//     dv over its slots in ascending slot order, in the first kernel's lane
//     layout, with C slots' view entries, destinations and per-head scalars
//     (one load a slot and head) and then their q and g runs in flight, the
//     next chunk's view entries with them.
// No float atomics, so a backward is bit-reproducible on one card. What
// stays between K4 and its bound (PERF.md section 6): the bound counts each
// row once, but every slot that names a source (or a destination) reads
// its k and v (q and g) row again through L2, as often as the row has
// slots, and a CTA's row groups wait on a chain of dependent loads (the
// window, q and g with the first chunk, later chunks).

#pragma once

#include "attn.cuh"

namespace {

// ---------------------------------------------------------------- K4

// K4's operands: K3's (out is dq) and the cotangent, the outputs dk and dv,
// the per-slot scalars, the dWe partials and the source-sorted slot view
template <typename S>
struct BwdParams : FwdParams<S> {
  const S* g;
  S* dk;               // (B, n_max, HD)
  S* dv;
  float* dlog;         // (B, T*EB, H) dlogit * scale per slot and head
  float* used;         // (B, T*EB, H) alpha * keep per slot and head
  float* dwe_part;     // (CTAs, A, HD): one partial a CTA of the first kernel
  S* dwe;              // (A, HD): the partials summed in CTA order, rounded once
  const int* order;    // (M*T*EB) slots by source node
  const int* offsets;  // (M, n_max + 1) slot ranges of the source nodes
  int parts;           // CTAs of the first kernel
  int src_ctas;        // CTAs of the second kernel that gather dk and dv
};

// Shared 4-byte words of one CTA of K4's first kernel (ops/attn.py
// bwd_smem_bytes): K3's, or the dWe reduction's warps * 32 * F words at
// the end, whichever is more.
__host__ __device__ constexpr int bwd_smem_words(int rows, int EB, int A, int warps, int run) {
  return fwd_smem_words(rows, EB, A) > 32 * warps * run ? fwd_smem_words(rows, EB, A)
                                                        : 32 * warps * run;
}

// The loads of slots jb .. jb + C of a row (those at or past hi are off):
// their k and v runs and keep values, all issued before any use.
template <typename S, int F, int C, bool VEC>
__device__ __forceinline__ void bwd_load(const BwdParams<S>& p, int jb, int hi, int first, bool on,
                                         const int* src, const S* kb, const S* vb, int col,
                                         int f0, const float* keep, float (&kr)[C][F],
                                         float (&vr)[C][F], float (&kp)[C]) {
  const int HD = p.H * p.D;
#pragma unroll
  for (int u = 0; u < C; ++u) {
    const int j = jb + u;
    const int sr = j < hi ? src[j] : -1;
    const int s = first + sr;
    const bool ok = on && sr >= 0 && sr < p.SW && s < p.n_max;
    const long long at_row = static_cast<long long>(ok ? s : 0) * HD + col;
    fwd_load<F, VEC>(kb + at_row, f0, p.D, ok, kr[u]);
    fwd_load<F, VEC>(vb + at_row, f0, p.D, ok, vr[u]);
    kp[u] = keep != nullptr && j < hi ? __ldg(keep + j) : 1.f;
  }
}

// From a chunk's loads: each slot's logit lg (log2 units; -inf when off)
// and dalpha da = keep * g . (v + e) (0 when off), each finished by an xor
// butterfly over the head's lanes. The edge term is folded: q . e =
// sum_a attr_a (q . We_a), with qw / gw the run's shares of q . We_a and
// g . We_a.
template <int F, int C, int NA>
__device__ __forceinline__ void bwd_logits(int jb, int hi, const float* at, int A, int lanes_head,
                                           const float (&qf)[F], const float (&gf)[F],
                                           const float (&qw)[NA], const float (&gw)[NA],
                                           float qscale, const float (&kr)[C][F],
                                           const float (&vr)[C][F], const float (&kp)[C],
                                           float (&lg)[C], float (&da)[C]) {
#pragma unroll
  for (int u = 0; u < C; ++u) {
    const int j = jb + u;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      s1 = fmaf(qf[i], kr[u][i], s1);
      s2 = fmaf(gf[i], vr[u][i], s2);
    }
#pragma unroll
    for (int a = 0; a < NA; ++a)
      if (a < A && j < hi) {
        s1 = fmaf(at[j * A + a], qw[a], s1);
        s2 = fmaf(at[j * A + a], gw[a], s2);
      }
    lg[u] = s1;
    da[u] = s2;
  }
  for (int o = 1; o < lanes_head; o <<= 1) {
#pragma unroll
    for (int u = 0; u < C; ++u) {
      lg[u] += __shfl_xor_sync(0xffffffffu, lg[u], o);
      da[u] += __shfl_xor_sync(0xffffffffu, da[u], o);
    }
  }
#pragma unroll
  for (int u = 0; u < C; ++u) {  // products rounded apart (__fmul_rn): no instance fuses them
    const bool live = jb + u < hi;
    lg[u] = live ? __fmul_rn(lg[u], qscale) : -INFINITY;
    da[u] = live ? __fmul_rn(kp[u], da[u]) : 0.f;
  }
}

// One live row group of K4's first kernel: rows r0 .. r0 + rows of tile t
// of sample b, the heads of `slice`. Writes dq and the rows' per-slot
// scalars and adds the rows' dWe terms to dwe, this lane's columns' sums.
template <typename S, int F, int C, bool VEC, int AT>
__device__ __forceinline__ void bwd_group_rows(const BwdParams<S>& p, int b, int t, int r0,
                                               int rows, int slice, long long row0,
                                               unsigned* fsm,
                                               float (&dwe)[AT > 0 ? AT : kMaxA][F]) {
  const int HD = p.H * p.D;
  constexpr int NA = AT > 0 ? AT : kMaxA;
  const int A = AT > 0 ? AT : p.A;
  const float qscale = p.scale * 1.44269504f;  // logits in log2 units: exp2f
  const long long tile = static_cast<long long>(b) * p.T + t;                // keep, scalars
  const long long mtile = static_cast<long long>(b * p.mstride) * p.T + t;  // the mesh's
  const int* start = reinterpret_cast<const int*>(fsm);
  const int* src = reinterpret_cast<const int*>(fsm + fwd_pad4(p.rows + 3)) + fwd_pad4(p.EB);
  const float* at = reinterpret_cast<const float*>(src + fwd_pad4(p.EB));  // EB * A
  const int first = __ldg(p.s0 + mtile);
  group_starts(p, mtile, r0, rows, fsm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % p.lanes_item;
  const int hl = sub / p.lanes_head;        // head within the slice
  const int f0 = (sub % p.lanes_head) * F;  // the lane's first feature within the head
  const int h = slice * p.heads_item + hl;
  const bool head_on = hl < p.heads_item && h < p.H;
  const bool lead = sub % p.lanes_head == 0;  // the head's first lane parks its scalars
  const int col = h * p.D + f0;
  const int ipw = 32 / p.lanes_item;
  const float* keep =
      p.keep != nullptr ? p.keep + (tile * p.KH + min(h, p.KH - 1)) * p.EB : nullptr;
  const S* kb = p.k + static_cast<long long>(b) * p.n_max * HD;
  const S* vb = p.v + static_cast<long long>(b) * p.n_max * HD;
  for (int i0 = 0; i0 < rows; i0 += p.warps * ipw) {  // uniform across the CTA
    const int item = i0 + warp * ipw + lane / p.lanes_item;
    const bool row_on = item < rows && head_on;  // uniform a head
    const bool on = row_on && f0 < p.D;
    const int lo = row_on ? start[item] : 0, hi = row_on ? start[item + 1] : 0;
    const long long orow = row0 + static_cast<long long>(item) * HD + col;
    // q, g and the first chunk's k, v and keep in flight together, then We
    float qf[F], gf[F], qw[NA], gw[NA];
    float kr[C][F], vr[C][F], kp[C], lg[C], da[C], pe[C];
    fwd_load<F, VEC>(p.q + orow, f0, p.D, on, qf);
    fwd_load<F, VEC>(p.g + orow, f0, p.D, on, gf);
    bwd_load<S, F, C, VEC>(p, lo, hi, first, on, src, kb, vb, col, f0, keep, kr, vr, kp);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      float wr[F];
      fwd_load<F, false>(p.we + a * HD + col, f0, p.D, on && a < A, wr);
      qw[a] = 0.f;
      gw[a] = 0.f;
#pragma unroll
      for (int i = 0; i < F; ++i) {
        qw[a] = fmaf(qf[i], wr[i], qw[a]);
        gw[a] = fmaf(gf[i], wr[i], gw[a]);
      }
    }
    // pass 1: max, denominator and rowdot = sum_j p_j * dalpha_j, online
    // over the chunks (the warp's most); the last chunk's k runs, logits
    // and exponentials stay in registers for pass 2
    const int nch = __reduce_max_sync(0xffffffffu, (hi - lo + C - 1) / C);
    float m = -INFINITY, den = 0.f, rd = 0.f;
    for (int c = 0; c < nch; ++c) {
      if (c > 0) bwd_load<S, F, C, VEC>(p, lo + c * C, hi, first, on, src, kb, vb, col, f0, keep,
                                        kr, vr, kp);
      bwd_logits<F, C, NA>(lo + c * C, hi, at, A, p.lanes_head, qf, gf, qw, gw, qscale, kr, vr,
                           kp, lg, da);
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        mx = fmaxf(mx, lg[u]);
        pe[u] = 0.f;
      }
      const float mn = fmaxf(m, mx);
      if (mn != -INFINITY) {
        const float corr = exp2f(m - mn);
        den = __fmul_rn(den, corr);
        rd = __fmul_rn(rd, corr);
#pragma unroll
        for (int u = 0; u < C; ++u) {
          pe[u] = exp2f(lg[u] - mn);
          den = __fadd_rn(den, pe[u]);
          rd = fmaf(pe[u], da[u], rd);
        }
        m = mn;
      }
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const float rowdot = __fmul_rn(rd, inv);
    // pass 2: alpha, dlog = dlogit * scale and used = alpha * keep per slot;
    // dq = sum_j dlog_j k_j + sum_a ad_a We_a with ad_a = sum_j dlog_j attr_ja
    // (and au_a = sum_j used_j attr_ja for dWe). The last chunk goes first,
    // from registers (its exponentials are already against the final max);
    // only rows longer than a chunk then read their earlier chunks again,
    // in order
    float dq[F], ad[NA], au[NA];
#pragma unroll
    for (int i = 0; i < F; ++i) dq[i] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) ad[a] = au[a] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int jb = lo + (c == 0 ? nch - 1 : c - 1) * C;
      if (c > 0) {
        bwd_load<S, F, C, VEC>(p, jb, hi, first, on, src, kb, vb, col, f0, keep, kr, vr, kp);
        bwd_logits<F, C, NA>(jb, hi, at, A, p.lanes_head, qf, gf, qw, gw, qscale, kr, vr, kp, lg,
                             da);
#pragma unroll
        for (int u = 0; u < C; ++u) pe[u] = jb + u < hi ? exp2f(lg[u] - m) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int j = jb + u;
        const bool live = j < hi;
        const float al = __fmul_rn(pe[u], inv);
        const float dl = live ? __fmul_rn(__fmul_rn(al, da[u] - rowdot), p.scale) : 0.f;
        const float us = live ? __fmul_rn(al, kp[u]) : 0.f;
#pragma unroll
        for (int i = 0; i < F; ++i) dq[i] = fmaf(dl, kr[u][i], dq[i]);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (a < A && live) {
            ad[a] = fmaf(dl, at[j * A + a], ad[a]);
            au[a] = fmaf(us, at[j * A + a], au[a]);
          }
        if (lead && row_on && live) {
          const long long sc = (tile * p.EB + j) * p.H + h;
          p.dlog[sc] = dl;
          p.used[sc] = us;
        }
      }
    }
    if (on) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        float wr[F];
        fwd_load<F, false>(p.we + a * HD + col, f0, p.D, a < A, wr);
#pragma unroll
        for (int i = 0; i < F; ++i) dq[i] = fmaf(ad[a], wr[i], dq[i]);
      }
      fwd_store<F, VEC>(p.out + orow, dq, 1.f, f0, p.D);
      // the row's dWe terms: q[n] * ad_a + g[n] * au_a, once a row
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int i = 0; i < F; ++i)
          dwe[a][i] = fmaf(gf[i], au[a], fmaf(qf[i], ad[a], dwe[a][i]));
    }
  }
}

// K4's first kernel: persistent CTAs over (row group, slice of heads)
// units. CTA c serves slice c % slices and walks the row groups c /
// slices, + gridDim.x / slices, ..., tile-major as K3 does, so that each
// lane's dWe columns stay fixed for the CTA; at the end the lanes that
// share a column are summed in (warp, item) order into the CTA's partial.
// Runs of 8 keep two CTAs a multiprocessor (128 registers a thread); the
// others take the registers their chunks need, one CTA.
template <typename S, int F, int C, bool VEC, int AT>
__global__ void __launch_bounds__(kFwdMaxWarps * 32, F == 8 ? 2 : 1)
    attn_bwd_kernel(BwdParams<S> p) {
  extern __shared__ __align__(16) unsigned fsm[];
  __shared__ int live_s[kFwdLive];
  constexpr int NA = AT > 0 ? AT : kMaxA;
  const int A = AT > 0 ? AT : p.A;
  const int meshes = p.mstride ? p.B : 1;
  for (int i = threadIdx.x; i < min(meshes, kFwdLive); i += blockDim.x)
    live_s[i] = __ldg(p.live + i);
  __syncthreads();
  const int HD = p.H * p.D;
  const int groups = (p.NT + p.rows - 1) / p.rows;
  const int n_groups = p.T * p.B * groups;
  const int slice = blockIdx.x % p.slices;
  const int walkers = gridDim.x / p.slices;  // the CTAs of this slice
  float dwe[NA][F];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < F; ++i) dwe[a][i] = 0.f;
  for (int g = blockIdx.x / p.slices; g < n_groups; g += walkers) {  // uniform across the CTA
    const int bt = g / groups;
    const int b = bt % p.B, t = bt / p.B;
    const int r0 = (g % groups) * p.rows;
    const int node0 = t * p.NT + r0;
    const int rows = min(min(p.rows, p.NT - r0), p.n_max - node0);
    if (rows <= 0) continue;
    const long long row0 = (static_cast<long long>(b) * p.n_max + node0) * HD;
    const int mb = b * p.mstride;
    if (t >= (mb < kFwdLive ? live_s[mb] : __ldg(p.live + mb))) {  // dead tile: zero dq rows
      if (slice == 0) fwd_zero(p.out + row0, static_cast<long long>(rows) * HD, p.vec_out);
      continue;
    }
    bwd_group_rows<S, F, C, VEC, AT>(p, b, t, r0, rows, slice, row0, fsm, dwe);
  }
  // this CTA's dWe partial, a column at a time
  float* red = reinterpret_cast<float*>(fsm);  // warps * 32 * F
  float* part = p.dwe_part + static_cast<long long>(blockIdx.x) * A * HD;
  const int ipw = 32 / p.lanes_item;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    if (a >= A) break;
    __syncthreads();  // shared memory is free
#pragma unroll
    for (int i = 0; i < F; ++i) red[threadIdx.x * F + i] = dwe[a][i];
    __syncthreads();
    for (int c = threadIdx.x; c < HD; c += blockDim.x) {
      const int hl = c / p.D - slice * p.heads_item, x = c % p.D;
      float s = 0.f;
      if (hl >= 0 && hl < p.heads_item) {  // lanes sub of every item of every warp
        const int sub = hl * p.lanes_head + x / F;
        for (int w = 0; w < p.warps; ++w)
          for (int k = 0; k < ipw; ++k) s += red[(w * 32 + k * p.lanes_item + sub) * F + x % F];
      }
      part[a * HD + c] = s;
    }
  }
}

// K4's second kernel: the lanes of (source node s, slice of heads) gather
//   dk[s] = sum_j dlog_j,h * q[dst_j],  dv[s] = sum_j used_j,h * g[dst_j]
// over the slots j whose source is s, in ascending slot order, through the
// source-sorted view (of the sample's mesh: one view for the batch on a
// shared mesh). K4's first kernel's lanes: lanes_head lanes a head, runs of
// F features (16-byte loads where VEC). Per chunk of C slots the view's
// entries, then their destinations and per-head scalars (one load a slot
// and head, broadcast to the head's lanes), then the q and g runs, are all
// loaded before any arithmetic, and the next chunk's view entries are
// loaded with this chunk's q and g. The CTAs past src_ctas sum the first
// kernel's dWe partials, a column a thread, in CTA order.
constexpr int kSrcThreads = 256;

template <typename S, int F, int C, bool VEC>
__global__ void __launch_bounds__(kSrcThreads) attn_bwd_src_kernel(BwdParams<S> p) {
  if (static_cast<int>(blockIdx.x) >= p.src_ctas) {  // dWe
    const int n = p.A * p.H * p.D;
    const int c = (blockIdx.x - p.src_ctas) * kSrcThreads + threadIdx.x;
    if (c < n) {
      float s = 0.f;
      for (int x = 0; x < p.parts; ++x) s += __ldg(p.dwe_part + static_cast<long long>(x) * n + c);
      p.dwe[c] = from_f<S>(s);
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ipw = 32 / p.lanes_item;
  const long long item =
      (static_cast<long long>(blockIdx.x) * (kSrcThreads / 32) + warp) * ipw + lane / p.lanes_item;
  const int sub = lane % p.lanes_item;
  const int hl = sub / p.lanes_head;
  const int f0 = (sub % p.lanes_head) * F;
  const long long row = item / p.slices;  // b * n_max + n
  const int h = static_cast<int>(item % p.slices) * p.heads_item + hl;
  const bool row_on = row < static_cast<long long>(p.B) * p.n_max && hl < p.heads_item && h < p.H;
  const bool on = row_on && f0 < p.D;
  const int b = row_on ? static_cast<int>(row / p.n_max) : 0;
  const int n = row_on ? static_cast<int>(row - static_cast<long long>(b) * p.n_max) : 0;
  const int mb = b * p.mstride;
  const int HD = p.H * p.D;
  const int col = h * p.D + f0;
  const long long L = static_cast<long long>(p.T) * p.EB;
  const int* off = p.offsets + static_cast<long long>(mb) * (p.n_max + 1) + n;
  const int start = row_on ? __ldg(off) : 0, end = row_on ? __ldg(off + 1) : 0;
  const S* qb = p.q + static_cast<long long>(b) * p.n_max * HD + col;
  const S* gb = p.g + static_cast<long long>(b) * p.n_max * HD + col;
  float dk[F], dv[F];
#pragma unroll
  for (int i = 0; i < F; ++i) dk[i] = dv[i] = 0.f;
  const int nch = __reduce_max_sync(0xffffffffu, (end - start + C - 1) / C);
  long long e[C];  // the chunk's view entries: mb * L + slot, -1 past the row
#pragma unroll
  for (int u = 0; u < C; ++u) e[u] = start + u < end ? __ldg(p.order + start + u) : -1;
  for (int c = 0; c < nch; ++c) {
    int drow[C];
    float dl[C], us[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      drow[u] = 0;
      dl[u] = us[u] = 0.f;
      if (e[u] >= 0) {
        const long long slot = e[u] - mb * L;
        drow[u] = static_cast<int>(slot / p.EB) * p.NT + __ldg(p.dst_rel + e[u]);
        const long long sc = (static_cast<long long>(b) * L + slot) * p.H + h;
        dl[u] = __ldg(p.dlog + sc);
        us[u] = __ldg(p.used + sc);
      }
    }
    const int jn = start + (c + 1) * C;
    long long en[C];
#pragma unroll
    for (int u = 0; u < C; ++u) en[u] = jn + u < end ? __ldg(p.order + jn + u) : -1;
    float qr[C][F], gr[C][F];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const long long at_row = static_cast<long long>(drow[u]) * HD;
      fwd_load<F, VEC>(qb + at_row, f0, p.D, on && e[u] >= 0, qr[u]);
      fwd_load<F, VEC>(gb + at_row, f0, p.D, on && e[u] >= 0, gr[u]);
    }
#pragma unroll
    for (int u = 0; u < C; ++u) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        dk[i] = fmaf(dl[u], qr[u][i], dk[i]);
        dv[i] = fmaf(us[u], gr[u][i], dv[i]);
      }
      e[u] = en[u];
    }
  }
  if (on) {
    fwd_store<F, VEC>(p.dk + row * HD + col, dk, 1.f, f0, p.D);
    fwd_store<F, VEC>(p.dv + row * HD + col, dv, 1.f, f0, p.D);
  }
}

// Launch both kernels of K4: the first with as many CTAs as the card holds
// at once (rounded down to whole slices, at least one a slice, at most one
// a unit, cached per instance as K3's), the second one thread a lane of
// every source row's items and one a dWe column; grid[0] and grid[1]
// receive the CTA counts.
template <typename S, int F, int C, bool VEC, int AT>
cudaError_t launch_bwd(const BwdParams<S>& p, int units, int smem, cudaStream_t stream,
                       int* grid) {
  const void* kernel = reinterpret_cast<const void*>(attn_bwd_kernel<S, F, C, VEC, AT>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<S, F, C, VEC, AT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int resident = fwd_resident(kernel, 32 * p.warps, smem);
  if (resident < 1) return cudaErrorInvalidConfiguration;
  grid[0] = min(units, max(1, resident / p.slices) * p.slices);
  attn_bwd_kernel<S, F, C, VEC, AT><<<grid[0], 32 * p.warps, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.B) * p.n_max * p.slices;
  const long long per_cta = (kSrcThreads / 32) * (32 / p.lanes_item);
  BwdParams<S> q = p;
  q.parts = grid[0];
  q.src_ctas = static_cast<int>((items + per_cta - 1) / per_cta);
  grid[1] = q.src_ctas + (p.A * p.H * p.D + kSrcThreads - 1) / kSrcThreads;
  attn_bwd_src_kernel<S, F, C, VEC><<<grid[1], kSrcThreads, 0, stream>>>(q);
  return cudaGetLastError();
}

// A = 2 (the quadtree meshes' edge attributes) is compiled apart.
template <typename S, int F, int C>
cudaError_t launch_bwd_run(const BwdParams<S>& p, bool vec, int units, int smem,
                           cudaStream_t stream, int* grid) {
  if constexpr (F % 4 == 0) {
    if (vec)
      return p.A == 2 ? launch_bwd<S, F, C, true, 2>(p, units, smem, stream, grid)
                      : launch_bwd<S, F, C, true, 0>(p, units, smem, stream, grid);
  }
  return p.A == 2 ? launch_bwd<S, F, C, false, 2>(p, units, smem, stream, grid)
                  : launch_bwd<S, F, C, false, 0>(p, units, smem, stream, grid);
}

// K4 on storage type S with the plan run .. chunk (ops/attn.py bwd_plan),
// its dWe partials at dwe_part (room for `units` of them: every (row group,
// slice) pair); geometry as for qtm_attn_bwd.
template <typename S>
int attn_bwd(const S* q, const S* k, const S* v, const S* we, const float* keep, const int* s0,
             const int* src_rel, const int* dst_rel, const float* attr, const int* live,
             const S* g, const int* order, const int* offsets, S* dq, S* dk, S* dv, float* dlog,
             float* used, float* dwe_part, S* dwe, int B, int meta_b, int T, int EB, int NT,
             int SW, int n_max, int H, int D, int A, int KH, int run, int lanes_head,
             int heads_item, int lanes_item, int slices, int warps, int rows, int chunk, int units,
             float scale, void* stream, int* geometry) {
  const long long smem = 4LL * bwd_smem_words(rows, EB, A, warps, run);
  const long long n_units =
      static_cast<long long>(B) * T * ((NT + rows - 1) / max(rows, 1)) * slices;
  if (bad_plan(B, meta_b, T, EB, NT, n_max, H, D, A, KH, keep != nullptr, run, lanes_head,
               heads_item, lanes_item, slices, warps, rows, chunk) ||
      (slices > 1 && lanes_item != 32) || smem > 227 * 1024 || n_units != units ||
      static_cast<long long>(B) * n_max * slices > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const bool vec = run % 4 == 0 && D % run == 0 && aligned(q) && aligned(k) && aligned(v) &&
                   aligned(g) && aligned(dq) && aligned(dk) && aligned(dv);
  const int vec_out = (H * D * sizeof(S)) % 16 == 0 && aligned(dq);
  const int vec_win = EB % 4 == 0 && aligned(src_rel) && aligned(dst_rel) && aligned(attr);
  int grid[2] = {0, 0};
  cudaError_t err = cudaSuccess;
  if (units > 0) {
    BwdParams<S> p;
    static_cast<FwdParams<S>&>(p) =
        FwdParams<S>{q,          k,          v,      we,    keep, s0,      src_rel, dst_rel,
                     attr,       live,       dq,     B,     T,    EB,      NT,      SW,
                     n_max,      H,          D,      A,     KH,   lanes_head,
                     heads_item, lanes_item, slices, warps, rows, vec_out, vec_win, scale,
                     meta_b == B ? 1 : 0};
    p.g = g;
    p.dk = dk;
    p.dv = dv;
    p.dlog = dlog;
    p.used = used;
    p.dwe_part = dwe_part;
    p.dwe = dwe;
    p.order = order;
    p.offsets = offsets;
    p.parts = p.src_ctas = 0;  // set at the launch
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int sm = static_cast<int>(smem);
    switch (run) {
      case 1: err = launch_bwd_run<S, 1, 16>(p, vec, units, sm, s, grid); break;
      case 2: err = launch_bwd_run<S, 2, 8>(p, vec, units, sm, s, grid); break;
      case 4:
        err = chunk == 4 ? launch_bwd_run<S, 4, 4>(p, vec, units, sm, s, grid)
                         : launch_bwd_run<S, 4, 8>(p, vec, units, sm, s, grid);
        break;
      case 8: err = launch_bwd_run<S, 8, 4>(p, vec, units, sm, s, grid); break;
      default: err = launch_bwd_run<S, 16, 2>(p, vec, units, sm, s, grid); break;
    }
  }
  if (geometry != nullptr) {
    const int gm[9] = {grid[0], units, 32 * warps, static_cast<int>(smem), run, chunk, vec,
                       vec_win, grid[1]};
    for (int i = 0; i < 9; ++i) geometry[i] = gm[i];
  }
  return static_cast<int>(err);
}

}  // namespace
