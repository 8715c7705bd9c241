// Fused TransformerConv aggregation on Hopper (sm_90a), kernels K3 and K4:
// what both kernels share and K3 itself. Included by attn.cu and attn_bf16.cu
// (K3's f32 and bf16 entry points) and by attn_bwd.cuh (K4), so that each
// dtype and kernel builds as a translation unit of its own, in parallel.
//
// K3 qtm_attn_fwd replaces the forward of attn_apply (_attn_impl /
// _fwd_kernel) of quadtree_mpnnlstm_tpu/ops/pallas_attn.py; K4
// qtm_attn_bwd replaces its backward (_attn_bwd / _bwd_kernel). For each
// destination node n, head h, and the window slots j whose destination is
// n (scale = 1/sqrt(d), e_j = attr_j . We):
//
//   logit_j = scale * q[n]_h . (k[src_j]_h + e_j,h)
//   out[n]_h = sum_j softmax(logit)_j * keep_j,h * (v[src_j]_h + e_j,h)
//
// The TPU kernel lays edges on lanes and turns every gather into a one-hot
// matmul (2*SW*EB*HD operations a tile, nearly all of them wasted). Here
// the window slots are dst-sorted (window_geometry): the live slots of a
// tile are a prefix sorted by destination, so each destination's slots are
// one contiguous range.
//
// Slots that are dead (dst_rel = -1), in dead tiles (t >= live[b]), or that
// reach a padding row at or past n_max are skipped; a source outside the
// window or past n_max reads a zero k/v row but still adds its edge term,
// as in the TPU kernel; a row with no slot gives 0. Every output row below
// n_max is written. Both kernels take a leading batch axis, and windows of
// one mesh for the whole batch (a shared mesh, TrainConfig.shared_mesh:
// meta_b = 1, a metadata batch stride of 0; every sample's sums are those
// of a mesh of its own, which the JAX package's fold of the samples into
// heads equals). They launch on the
// caller's stream, do not synchronise, allocate nothing and use no float
// atomics, so a repeated call is bit-identical; each entry point returns
// cudaGetLastError() (or cudaErrorInvalidValue for a geometry it does not
// take) so that the Python wrapper raises on a refused launch.
//
// K3 (attn_fwd_kernel). Bound by bytes: per live slot it reads a k and a v
// row (8*HD bytes) against about 2*A*HD + 4*HD operations, far below the
// card's 20 operations per byte of f32; at the main path's HD 128 the
// output write of every row below n_max (dead tiles included) is most of
// the bound. What costs time is latency (a gather per slot) and, once the
// loads are in flight, instruction throughput. The design, with its geometry
// from the host (ops/attn.py fwd_plan, passed in):
//   - Work is cut into row groups of (sample, tile, 32 rows), numbered
//     tile-major (every sample's tile 0 first). The grid is as many CTAs
//     as the card holds at once (occupancy, cached per instance), at most
//     one a group; CTA c takes groups c, c + grid, ... So the grid follows
//     the card, not T x groups, and live groups, which come first, spread
//     over all SMs; a dead tile's group only stores zeros (16-byte stores)
//     after the CTA's live work.
//   - A live group stages its tile's dst_rel, src_rel and attributes with
//     16-byte cp.async in one round trip; warp 0 finds the group's slot
//     range by a 32-way ballot search, and the CTA scans only that range
//     for each row's first slot (row r's slots are [start[r], start[r+1])).
//   - Lanes over heads: a (row, slice of heads) item takes lanes_item
//     lanes, lanes_head lanes a head, each lane a run of RUN contiguous
//     features of q, k, v, We and out (float4 loads and stores where
//     d % 4 == 0). At d 16 a head is 4 lanes x 4 features, so a warp holds
//     one row at HD 128, 8 rows at HD 16 and 32 rows at HD 1; at 8 x d 32
//     a head is 4 lanes x 8 features. A row wider than a warp's lanes
//     takes several slices, so any heads.d runs in one launch on the
//     full-width operands (HD 768 as 24 x d 32: two slices of 16 heads of
//     2 lanes x 16 features).
//   - The edge term is folded: q . (k + e) = q . k + sum_a attr_a (q . We_a)
//     and sum_j w_j (v_j + e_j) = sum_j w_j v_j + sum_a (sum_j w_j attr_ja)
//     We_a, so a slot costs RUN + A multiply-adds a lane on each side, not
//     RUN * (A + 2). A = 2 (the quadtree meshes') is compiled apart.
//   - Per item the slots go in chunks of C (4 when a warp holds one row,
//     as most rows have 4 slots; 8 or 16 when it packs rows): the chunk's k
//     and v runs and keep values are loaded into registers before any
//     arithmetic on them, q's and We's with the first. Each lane sums its
//     run, an xor butterfly over the head's lanes finishes the head's dot
//     product (every lane gets the same sum; no shared buffer, no
//     __syncwarp), and the online softmax, in log2 units (scale * log2(e)
//     folded into q, exp2f), takes one max and one rescale per (chunk,
//     head) and one exp2f per (slot, head). Sums run in ascending slot
//     order. The chunk loop's trip count is the warp's largest, so the
//     shuffles run with the whole warp; slots past an item's range weigh 0.
//
// K4: attn_bwd.cuh.
//
// bf16 (qtm_attn_fwd_bf16, qtm_attn_bwd_bf16; the TPU kernels on bf16 q,
// k, v, We and g): every kernel is templated on the storage type S of q, k,
// v, We, g and of the outputs out, dq, dk and dv. A bf16 value is widened
// to f32 on load, every product, sum and the softmax run in f32 in the f32
// kernel's order, and each output is rounded to bf16 once, on store (the
// TPU kernel computes in f32 too and casts each output once). The window
// attributes, keep, the per-slot scalars and the dWe partials stay f32,
// and K4 sums the partials in f32 before it rounds dWe once. K3's bf16
// runs move run * 2 bytes a load (8 bytes at run 4, 16 at run 8); K4's
// plan takes runs of 8 where d allows, so that its bf16 loads are 16 bytes
// as its f32 ones are.

#pragma once

#include <cuda_bf16.h>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// An f32 rounded to the storage type (bf16: to nearest even, once).
template <typename S>
__device__ __forceinline__ S from_f(float x) {
  if constexpr (std::is_same<S, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// Read-only cached load of one stored value, as f32.
__device__ __forceinline__ float ldg_f(const float* x) { return __ldg(x); }
__device__ __forceinline__ float ldg_f(const bf16* x) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(x))) << 16);
}

// The two bf16 values of a 32-bit word (the first in the low half) as f32,
// and two f32 rounded to bf16 and packed so.
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf_pack(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

constexpr int kMaxA = 4;  // edge-attribute columns

// ---------------------------------------------------------------- K3

constexpr int kFwdMaxWarps = 8;

// The compiled (run, chunk) pairs: features a lane holds, slots a lane
// holds in flight (ops/attn.py FWD_INSTANCES).
bool fwd_instance(int run, int chunk) {
  return (run == 1 && chunk == 16) || (run == 2 && chunk == 8) ||
         (run == 4 && (chunk == 4 || chunk == 8)) || (run == 8 && chunk == 4) ||
         (run == 16 && chunk == 2);
}

__host__ __device__ constexpr int fwd_pad4(int n) { return (n + 3) & ~3; }

// Shared 4-byte words of one K3 CTA (ops/attn.py fwd_smem_bytes): the rows'
// first slots and the group's slot range, then the tile's dst_rel, src_rel
// and attributes; each part starts 16-byte aligned.
__host__ __device__ constexpr int fwd_smem_words(int rows, int EB, int A) {
  return fwd_pad4(rows + 3) + 2 * fwd_pad4(EB) + EB * A;
}

// live[] of the first kFwdLive samples is kept in shared memory.
constexpr int kFwdLive = 256;

// K3's operands; S is the storage type of q, k, v, We and out
template <typename S>
struct FwdParams {
  const S* q;
  const S* k;
  const S* v;
  const S* we;
  const float* keep;  // (B, T, KH, EB) or null (no dropout)
  const int* s0;
  const int* src_rel;
  const int* dst_rel;
  const float* attr;
  const int* live;
  S* out;
  int B, T, EB, NT, SW, n_max, H, D, A, KH;
  // the plan: lanes a head, heads an item, lanes an item, items a row,
  // warps a CTA, rows a CTA
  int lanes_head, heads_item, lanes_item, slices, warps, rows;
  int vec_out;  // 16-byte zero stores (HD * sizeof(S) % 16 == 0, out 16-byte aligned)
  int vec_win;  // 16-byte window copies (EB % 4 == 0, windows 16-byte aligned)
  float scale;
  int mstride;  // 1: a mesh a sample; 0: one mesh (windows) for the batch
};

__device__ __forceinline__ void fwd_cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void fwd_cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void fwd_cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy the n words at src to dst with the CTA's threads, 16 bytes a copy
// when vec (src 16-byte aligned).
__device__ __forceinline__ void fwd_stage(unsigned* dst, const unsigned* src, int n, bool vec) {
  int done = 0;
  if (vec) {
    done = n & ~3;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * blockDim.x) fwd_cp16(dst + i, src + i);
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) fwd_cp4(dst + i, src + i);
}

template <typename S>
__device__ __forceinline__ void fwd_zero(S* out, long long n, bool vec) {
  constexpr long long kPer = 16 / sizeof(S);  // values a 16-byte store
  long long done = 0;
  if (vec) {
    done = n & ~(kPer - 1);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = threadIdx.x; i < done / kPer; i += blockDim.x)
      o4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) out[i] = from_f<S>(0.f);
}

// The lane's run of F features at x as f32 (features f0 .. f0 + F of a head
// of width D; zero where f0 + i >= D or !ok). VEC: the run lies wholly
// inside or outside the head and is aligned to its size up to 16 bytes
// (f32: float4 loads; bf16: one 8-byte load at F 4, 16-byte loads above).
template <int F, bool VEC, typename S>
__device__ __forceinline__ void fwd_load(const S* x, int f0, int D, bool ok, float (&r)[F]) {
  if constexpr (VEC && std::is_same<S, float>::value) {
#pragma unroll
    for (int i = 0; i < F; i += 4) {
      const float4 t =
          ok ? __ldg(reinterpret_cast<const float4*>(x + i)) : make_float4(0.f, 0.f, 0.f, 0.f);
      r[i] = t.x;
      r[i + 1] = t.y;
      r[i + 2] = t.z;
      r[i + 3] = t.w;
    }
  } else if constexpr (VEC && F % 8 == 0) {
#pragma unroll
    for (int i = 0; i < F; i += 8) {
      const uint4 t = ok ? __ldg(reinterpret_cast<const uint4*>(x + i)) : make_uint4(0u, 0u, 0u, 0u);
      r[i] = bf_lo(t.x);
      r[i + 1] = bf_hi(t.x);
      r[i + 2] = bf_lo(t.y);
      r[i + 3] = bf_hi(t.y);
      r[i + 4] = bf_lo(t.z);
      r[i + 5] = bf_hi(t.z);
      r[i + 6] = bf_lo(t.w);
      r[i + 7] = bf_hi(t.w);
    }
  } else if constexpr (VEC) {
    static_assert(F == 4, "bf16 runs load 4 values as 8 bytes, or 8 as 16");
    const uint2 t = ok ? __ldg(reinterpret_cast<const uint2*>(x)) : make_uint2(0u, 0u);
    r[0] = bf_lo(t.x);
    r[1] = bf_hi(t.x);
    r[2] = bf_lo(t.y);
    r[3] = bf_hi(t.y);
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) r[i] = ok && f0 + i < D ? ldg_f(x + i) : 0.f;
  }
}

// Store the lane's run of F outputs acc * inv at o, rounded to S once. VEC
// as for fwd_load.
template <int F, bool VEC, typename S>
__device__ __forceinline__ void fwd_store(S* o, const float (&acc)[F], float inv, int f0, int D) {
  if constexpr (VEC && std::is_same<S, float>::value) {
#pragma unroll
    for (int i = 0; i < F; i += 4)
      *reinterpret_cast<float4*>(o + i) =
          make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv, acc[i + 3] * inv);
  } else if constexpr (VEC && F % 8 == 0) {
#pragma unroll
    for (int i = 0; i < F; i += 8)
      *reinterpret_cast<uint4*>(o + i) =
          make_uint4(bf_pack(acc[i] * inv, acc[i + 1] * inv), bf_pack(acc[i + 2] * inv, acc[i + 3] * inv),
                     bf_pack(acc[i + 4] * inv, acc[i + 5] * inv), bf_pack(acc[i + 6] * inv, acc[i + 7] * inv));
  } else if constexpr (VEC) {
    static_assert(F == 4, "bf16 runs store 4 values as 8 bytes, or 8 as 16");
    *reinterpret_cast<uint2*>(o) =
        make_uint2(bf_pack(acc[0] * inv, acc[1] * inv), bf_pack(acc[2] * inv, acc[3] * inv));
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i)
      if (f0 + i < D) o[i] = from_f<S>(acc[i] * inv);
  }
}

// A slot's sort key: its destination row; dead slots (-1) sort last.
__device__ __forceinline__ int fwd_key(int dst) { return dst < 0 ? INT_MAX : dst; }

// Stage tile `tile`'s window (dst_rel, src_rel, attributes) behind the
// rows' first slots, with cp.async, and wait for it.
template <typename S>
__device__ __forceinline__ void stage_tile(const FwdParams<S>& p, long long tile, unsigned* fsm) {
  const auto words = [](const void* x) { return reinterpret_cast<const unsigned*>(x); };
  unsigned* base = fsm + fwd_pad4(p.rows + 3);
  fwd_stage(base, words(p.dst_rel + tile * p.EB), p.EB, p.vec_win);
  fwd_stage(base + fwd_pad4(p.EB), words(p.src_rel + tile * p.EB), p.EB, p.vec_win);
  fwd_stage(base + 2 * fwd_pad4(p.EB), words(p.attr + tile * p.EB * p.A), p.EB * p.A,
            p.vec_win);
  fwd_cp_wait();
}

// The first slot j in [0, n) whose destination is at or past row r (n if
// none), found by one warp: each step narrows the range 32-fold.
__device__ __forceinline__ int fwd_lower_bound(const int* dst, int n, int r, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int pos = lo + lane * step;
    const int k = __popc(__ballot_sync(0xffffffffu, pos < hi && fwd_key(dst[pos]) < r));
    hi = min(hi, lo + k * step);
    lo = k > 0 ? lo + (k - 1) * step + 1 : lo;
  }
  return lo + __popc(__ballot_sync(0xffffffffu, lo + lane < hi && fwd_key(dst[lo + lane]) < r));
}

// Steps 1 and 2 of a live row group (K3's and K4's): stage tile mtile's
// window (dst_rel, src_rel, attributes) in one round trip, then find
// start[i], the first slot whose destination is at or past row r0 + i
// (i <= rows; rows r0 + i's slots are [start[i], start[i + 1])). Warp 0
// (and 1) find the group's slot range by ballot, then the CTA scans only
// that range. Ends with the CTA synchronised.
template <typename S>
__device__ __forceinline__ void group_starts(const FwdParams<S>& p, long long mtile, int r0,
                                             int rows, unsigned* fsm) {
  int* start = reinterpret_cast<int*>(fsm);  // rows + 1, then the group's slot range
  const int* dst = reinterpret_cast<const int*>(fsm + fwd_pad4(p.rows + 3));
  __syncthreads();  // the previous group's readers of shared memory are done
  stage_tile(p, mtile, fsm);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 2) {
    for (int e = warp; e < 2; e += blockDim.x / 32) {
      const int j = fwd_lower_bound(dst, p.EB, r0 + e * rows, lane);
      if (lane == 0) start[p.rows + 1 + e] = j;
    }
  }
  __syncthreads();
  const int j0 = start[p.rows + 1], j1 = start[p.rows + 2];
  for (int j = j0 + threadIdx.x; j <= j1; j += blockDim.x) {
    // rows (key(j - 1), key(j)] start at j; clamped so that nothing overflows
    const int kp = j == j0 ? r0 - 1 : max(min(fwd_key(dst[j - 1]), r0 + rows), r0 - 1);
    const int kc = j == p.EB ? r0 + rows : min(fwd_key(dst[j]), r0 + rows);
    for (int r = kp + 1; r <= kc; ++r) start[r - r0] = j;
  }
  __syncthreads();
}

// One live row group of K3: rows r0 .. r0 + rows of tile t of sample b.
// AT: the attribute columns when fixed at compile time (0: p.A).
template <typename S, int F, int C, bool VEC, int AT>
__device__ __forceinline__ void group_rows(const FwdParams<S>& p, int b, int t, int r0, int rows,
                                           long long out0, unsigned* fsm) {
  const int HD = p.H * p.D;
  constexpr int NA = AT > 0 ? AT : kMaxA;
  const int A = AT > 0 ? AT : p.A;
  const float qscale = p.scale * 1.44269504f;  // logits in log2 units: exp2f
  const long long tile = static_cast<long long>(b) * p.T + t;                // the keep window
  const long long mtile = static_cast<long long>(b * p.mstride) * p.T + t;  // the mesh's
  const int* start = reinterpret_cast<const int*>(fsm);
  const int* src = reinterpret_cast<const int*>(fsm + fwd_pad4(p.rows + 3)) + fwd_pad4(p.EB);
  const float* at = reinterpret_cast<const float*>(src + fwd_pad4(p.EB));  // EB * A
  // 1-2. the tile's window and the rows' first slots
  const int first = __ldg(p.s0 + mtile);
  group_starts(p, mtile, r0, rows, fsm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // 3. the group's items, warps x items a warp at a time
  const int sub = lane % p.lanes_item;
  const int hl = sub / p.lanes_head;         // head within the item
  const int f0 = (sub % p.lanes_head) * F;   // the lane's first feature within the head
  const int ipw = 32 / p.lanes_item;
  const int items = rows * p.slices;
  const float* keep = p.keep != nullptr ? p.keep + tile * p.KH * p.EB : nullptr;
  const S* kb = p.k + static_cast<long long>(b) * p.n_max * HD;
  const S* vb = p.v + static_cast<long long>(b) * p.n_max * HD;
  for (int i0 = 0; i0 < items; i0 += p.warps * ipw) {  // uniform across the CTA
    const int item = i0 + warp * ipw + lane / p.lanes_item;
    const int ri = item / p.slices;
    const int h = (item % p.slices) * p.heads_item + hl;
    const bool row_on = item < items && hl < p.heads_item && h < p.H;  // uniform a head
    const bool on = row_on && f0 < p.D;
    const int col = h * p.D + f0;
    const int lo = row_on ? start[ri] : 0, hi = row_on ? start[ri + 1] : 0;
    const long long orow = out0 + static_cast<long long>(ri) * HD + col;
    float qf[F], acc[F], qw[NA], om[NA];
    fwd_load<F, VEC>(p.q + orow, f0, p.D, on, qf);
#pragma unroll
    for (int a = 0; a < NA; ++a) om[a] = 0.f;
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = 0.f;
    float m = -INFINITY, l = 0.f;
    const int nch = __reduce_max_sync(0xffffffffu, (hi - lo + C - 1) / C);
    for (int c = 0; c < nch; ++c) {
      const int jb = lo + c * C;
      float kr[C][F], vr[C][F], kp[C], lg[C];
#pragma unroll
      for (int u = 0; u < C; ++u) {  // the chunk's loads, in flight with q's and We's
        const int j = jb + u;
        const int sr = j < hi ? src[j] : -1;
        const int s = first + sr;
        const bool ok = on && sr >= 0 && sr < p.SW && s < p.n_max;
        const long long at_row = static_cast<long long>(ok ? s : 0) * HD + col;
        fwd_load<F, VEC>(kb + at_row, f0, p.D, ok, kr[u]);
        fwd_load<F, VEC>(vb + at_row, f0, p.D, ok, vr[u]);
        kp[u] = keep != nullptr && j < hi
                    ? __ldg(keep + static_cast<long long>(min(h, p.KH - 1)) * p.EB + j)
                    : 1.f;
      }
      if (c == 0) {  // q in log2 units, and qw[a]: the run's share of q . We[a]
#pragma unroll
        for (int i = 0; i < F; ++i) qf[i] *= qscale;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          float wr[F];
          fwd_load<F, false>(p.we + a * HD + col, f0, p.D, on && a < A, wr);
          qw[a] = 0.f;
#pragma unroll
          for (int i = 0; i < F; ++i) qw[a] = fmaf(qf[i], wr[i], qw[a]);
        }
      }
#pragma unroll
      for (int u = 0; u < C; ++u) {  // the run's share of the logit, edge term included
        const int j = jb + u;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < F; ++i) s = fmaf(qf[i], kr[u][i], s);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (a < A && j < hi) s = fmaf(at[j * A + a], qw[a], s);
        lg[u] = s;
      }
      for (int o = 1; o < p.lanes_head; o <<= 1) {  // the head's lanes: xor butterfly
#pragma unroll
        for (int u = 0; u < C; ++u) lg[u] += __shfl_xor_sync(0xffffffffu, lg[u], o);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        lg[u] = jb + u < hi ? lg[u] : -INFINITY;
        mx = fmaxf(mx, lg[u]);
      }
      const float mn = fmaxf(m, mx);
      if (mn != -INFINITY) {  // online softmax: one rescale a chunk, slots in order
        const float corr = exp2f(m - mn);
        l *= corr;
#pragma unroll
        for (int i = 0; i < F; ++i) acc[i] *= corr;
#pragma unroll
        for (int a = 0; a < NA; ++a) om[a] *= corr;
#pragma unroll
        for (int u = 0; u < C; ++u) {
          const int j = jb + u;
          const float pe = exp2f(lg[u] - mn);
          l += pe;
          const float wt = pe * kp[u];
#pragma unroll
          for (int i = 0; i < F; ++i) acc[i] = fmaf(wt, vr[u][i], acc[i]);
#pragma unroll
          for (int a = 0; a < NA; ++a)
            if (a < A && j < hi) om[a] = fmaf(wt, at[j * A + a], om[a]);
        }
        m = mn;
      }
    }
    if (on) {  // out = (acc + sum_a om[a] * We[a]) / l
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        float wr[F];
        fwd_load<F, false>(p.we + a * HD + col, f0, p.D, a < A, wr);
#pragma unroll
        for (int i = 0; i < F; ++i) acc[i] = fmaf(om[a], wr[i], acc[i]);
      }
      fwd_store<F, VEC>(p.out + orow, acc, inv, f0, p.D);
    }
  }
}

template <typename S, int F, int C, bool VEC, int AT>
__global__ void __launch_bounds__(kFwdMaxWarps * 32, 2) attn_fwd_kernel(FwdParams<S> p) {
  extern __shared__ __align__(16) unsigned fsm[];
  __shared__ int live_s[kFwdLive];
  const int meshes = p.mstride ? p.B : 1;
  for (int i = threadIdx.x; i < min(meshes, kFwdLive); i += blockDim.x) live_s[i] = __ldg(p.live + i);
  __syncthreads();
  const int HD = p.H * p.D;
  const int groups = (p.NT + p.rows - 1) / p.rows;
  const int n_groups = p.T * p.B * groups;
  // This CTA's row groups, g = blockIdx.x + k * gridDim.x, tile-major
  // (every sample's tile 0 first): live groups come first, and dead tiles'
  // zero stores last.
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {  // uniform across the CTA
    const int bt = g / groups;
    const int b = bt % p.B, t = bt / p.B;
    const int r0 = (g % groups) * p.rows;
    const int node0 = t * p.NT + r0;
    const int rows = min(min(p.rows, p.NT - r0), p.n_max - node0);
    if (rows <= 0) continue;
    const long long out0 = (static_cast<long long>(b) * p.n_max + node0) * HD;
    const int mb = b * p.mstride;
    if (t >= (mb < kFwdLive ? live_s[mb] : __ldg(p.live + mb))) {  // dead tile: zero rows
      fwd_zero(p.out + out0, static_cast<long long>(rows) * HD, p.vec_out);
      continue;
    }
    group_rows<S, F, C, VEC, AT>(p, b, t, r0, rows, out0, fsm);
  }
}

// CTAs of one K3 instance resident on the card at this block size and
// shared memory (cached: the occupancy query costs host time every call).
int fwd_resident(const void* kernel, int block, int smem) {
  struct Entry {
    const void* kernel;
    int dev, block, smem, ctas;
  };
  static Entry cache[64];
  static int n = 0;
  static std::mutex lock;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].block == block &&
        cache[i].smem == smem)
      return cache[i].ctas;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem) != cudaSuccess)
    return 0;
  if (n < 64) cache[n++] = Entry{kernel, dev, block, smem, sms * per_sm};
  return sms * per_sm;
}

// Launch K3 with one CTA per resident slot (at most one per row group);
// grid[0] receives the CTA count.
template <typename S, int F, int C, bool VEC, int AT>
cudaError_t launch_fwd(const FwdParams<S>& p, int n_groups, int smem, cudaStream_t stream,
                       int* grid) {
  const void* kernel = reinterpret_cast<const void*>(attn_fwd_kernel<S, F, C, VEC, AT>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<S, F, C, VEC, AT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int resident = fwd_resident(kernel, 32 * p.warps, smem);
  if (resident < 1) return cudaErrorInvalidConfiguration;
  *grid = min(n_groups, resident);
  attn_fwd_kernel<S, F, C, VEC, AT><<<*grid, 32 * p.warps, smem, stream>>>(p);
  return cudaGetLastError();
}

// A = 2 (the quadtree meshes' edge attributes) is compiled apart.
template <typename S, int F, int C>
cudaError_t launch_fwd_run(const FwdParams<S>& p, bool vec, int n_groups, int smem,
                           cudaStream_t stream, int* grid) {
  if constexpr (F % 4 == 0) {
    if (vec)
      return p.A == 2 ? launch_fwd<S, F, C, true, 2>(p, n_groups, smem, stream, grid)
                      : launch_fwd<S, F, C, true, 0>(p, n_groups, smem, stream, grid);
  }
  return p.A == 2 ? launch_fwd<S, F, C, false, 2>(p, n_groups, smem, stream, grid)
                  : launch_fwd<S, F, C, false, 0>(p, n_groups, smem, stream, grid);
}


bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// Whether K3's or K4's operand widths or plan are ones the kernels do not
// take (ops/attn.py fwd_plan, bwd_plan).
bool bad_plan(int B, int meta_b, int T, int EB, int NT, int n_max, int H, int D, int A, int KH,
              bool keep, int run, int lanes_head, int heads_item, int lanes_item, int slices,
              int warps, int rows, int chunk) {
  return B < 0 || (meta_b != B && meta_b != 1) || T < 0 || EB < 1 || NT < 1 || n_max < 1 ||
         A < 1 || A > kMaxA || H < 1 || D < 1 || KH < 0 || KH > H ||
         (KH == 0) == keep || !fwd_instance(run, chunk) || !pow2(lanes_head) ||
         lanes_head > 32 || lanes_head * run < D || heads_item < 1 || !pow2(lanes_item) ||
         lanes_item > 32 || heads_item * lanes_head > lanes_item || slices < 1 ||
         slices * heads_item < H || warps < 1 || warps > kFwdMaxWarps || rows < 1 || rows > NT;
}

// K3 on storage type S with the plan run .. chunk (ops/attn.py fwd_plan);
// geometry as for qtm_attn_fwd.
template <typename S>
int attn_fwd(const S* q, const S* k, const S* v, const S* we, const float* keep, const int* s0,
             const int* src_rel, const int* dst_rel, const float* attr, const int* live, S* out,
             int B, int meta_b, int T, int EB, int NT, int SW, int n_max, int H, int D, int A,
             int KH, int run, int lanes_head, int heads_item, int lanes_item, int slices,
             int warps, int rows, int chunk, float scale, void* stream, int* geometry) {
  const long long smem = 4LL * fwd_smem_words(rows, EB, A);
  const long long n_groups = static_cast<long long>(B) * T * ((NT + rows - 1) / max(rows, 1));
  if (bad_plan(B, meta_b, T, EB, NT, n_max, H, D, A, KH, keep != nullptr, run, lanes_head,
               heads_item, lanes_item, slices, warps, rows, chunk) ||
      smem > 227 * 1024 || n_groups > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const bool vec = run % 4 == 0 && D % run == 0 && aligned(q) && aligned(k) && aligned(v) &&
                   aligned(out);
  const int vec_out = (H * D * sizeof(S)) % 16 == 0 && aligned(out);
  const int vec_win = EB % 4 == 0 && aligned(src_rel) && aligned(dst_rel) && aligned(attr);
  int grid = 0;
  cudaError_t err = cudaSuccess;
  if (n_groups > 0) {
    const FwdParams<S> p{q,     k,          v,          we,         keep,   s0,    src_rel, dst_rel,
                         attr,  live,       out,        B,          T,      EB,    NT,      SW,
                         n_max, H,          D,          A,          KH,     lanes_head,
                         heads_item,        lanes_item, slices,     warps,  rows,  vec_out, vec_win,
                         scale, meta_b == B ? 1 : 0};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int g = static_cast<int>(n_groups), sm = static_cast<int>(smem);
    switch (run) {
      case 1: err = launch_fwd_run<S, 1, 16>(p, vec, g, sm, s, &grid); break;
      case 2: err = launch_fwd_run<S, 2, 8>(p, vec, g, sm, s, &grid); break;
      case 4:
        err = chunk == 4 ? launch_fwd_run<S, 4, 4>(p, vec, g, sm, s, &grid)
                         : launch_fwd_run<S, 4, 8>(p, vec, g, sm, s, &grid);
        break;
      case 8: err = launch_fwd_run<S, 8, 4>(p, vec, g, sm, s, &grid); break;
      default: err = launch_fwd_run<S, 16, 2>(p, vec, g, sm, s, &grid); break;
    }
  }
  if (geometry != nullptr) {
    const int gm[8] = {grid, static_cast<int>(n_groups), 32 * warps, static_cast<int>(smem),
                       run, chunk, vec, vec_win};
    for (int i = 0; i < 8; ++i) geometry[i] = gm[i];
  }
  return static_cast<int>(err);
}

}  // namespace
