// Fused TransformerConv aggregation on Hopper (sm_90a): kernels K3 and K4.
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
//     a head is 4 lanes x 8 features.
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
// K4 runs in two kernels with no float atomics, so a backward is
// bit-reproducible. The first (attn_bwd_kernel) keeps the first port's
// per-destination design: one CTA serves ROWS_PER_CTA destination rows of one (sample,
// tile) and finds their ranges by a scan of the tile's dst_rel (scan_rows),
// one warp a row at a time with the lanes over the HD features (lane l
// holds features l, l + 32, ...); per slot the warp reads the source's k
// and v rows (load_slot) and sums the per-head dot products through a
// per-warp shared buffer (head_sums). It recomputes the row's max and
// denominator and the row dot sum_j alpha_j * dalpha_j in a first pass over
// the slots, then in a second pass forms dlogit = alpha * (dalpha - rowdot)
// and writes
//   dq[n] = sum_j dlogit_j * scale * (k + e)_j   (the warp owns the row),
// parks two scalars per slot and head, dlog_j = dlogit_j * scale and
// used_j = alpha_j * keep_j (4 bytes each, not an HD-wide row), and
// accumulates dWe += attr_j (x) (dlog_j q[n] + used_j g[n]) in registers,
// then sums the CTA's warps in a fixed order into one dWe partial per CTA
// (summed outside in a fixed order). The second (attn_bwd_src_kernel) is
// owner-computes over the source-sorted slot view that the graph builds
// once per mesh (ops/attn.py slot_view): the lanes of source node s gather
//   dk[s] = sum_j dlog_j q[dst_j],  dv[s] = sum_j used_j g[dst_j]
// over its slots in ascending slot order.
//
// K4's bound: bytes. Per live slot it reads a k and a v row and, per
// source slot, q and g rows again, against about 4*A*HD + 11*HD
// operations. What its first kernel's simple design leaves on the table
// (16-row CTAs on few live tiles, serial per-row slot loops with one slot's
// loads in flight, idle lanes at HD < 32) is a later PR's work.
//
// bf16 (qtm_attn_fwd_bf16, qtm_attn_bwd_bf16; the TPU kernels on bf16 q,
// k, v, We and g): every kernel is templated on the storage type S of q, k,
// v, We, g and of the outputs out, dq, dk and dv. A bf16 value is widened
// to f32 on load, every product, sum and the softmax run in f32 in the f32
// kernel's order, and each output is rounded to bf16 once, on store (the
// TPU kernel computes in f32 too and casts each output once). The window
// attributes, keep, the per-slot scalars and the dWe partials stay f32,
// and the wrapper sums the partials in f32 before it casts dWe. K3's bf16
// runs move run * 2 bytes a load (8 bytes at run 4, 16 at run 8). The f32
// instances are the f32 kernels unchanged.

#include <cuda_bf16.h>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
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

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 32;  // K4: destination rows per CTA (the wrapper passes 16)
constexpr int kMaxA = 4;      // edge-attribute columns

// K4's operands; S is the storage type of q, k, v, We, g, dq, dk and dv
template <typename S>
struct Params {
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
  const S* g;         // the cotangent
  S* out;             // dq
  float* dlog;        // K4: (B, T*EB, H) dlogit * scale per slot and head
  float* used;        // K4: (B, T*EB, H) alpha * keep per slot and head
  float* dwe_part;    // K4: (B, T*groups, A, HD)
  const int* order;   // K4: (B*T*EB) slots by source node (the source-sorted view)
  const int* offsets; // K4: (B, n_max + 1) slot ranges of the source nodes
  S* dk;              // K4: (B, n_max, HD)
  S* dv;
  int T, EB, NT, SW, n_max, H, D, A, KH, rows;
  float scale;
  int mstride;        // 1: a mesh a sample; 0: one mesh (windows, view) for the batch
};

// Row ranges [lo, hi) of the slots of rows r0 .. r0 + rows of one tile
// window, at slot wm of the windows (dst-sorted, so each row's slots are
// contiguous); rows without a slot keep lo = hi = 0. Ends with the CTA
// synchronised.
template <typename S>
__device__ __forceinline__ void scan_rows(const Params<S>& p, long long wm, int r0, int* lo,
                                          int* hi) {
  for (int i = threadIdx.x; i < p.rows; i += blockDim.x) {
    lo[i] = 0;
    hi[i] = 0;
  }
  __syncthreads();
  const int* dst = p.dst_rel + wm;
  for (int j = threadIdx.x; j < p.EB; j += blockDim.x) {
    const int d = dst[j];
    if (d >= r0 && d < r0 + p.rows) {
      if (j == 0 || dst[j - 1] != d) lo[d - r0] = j;
      if (j == p.EB - 1 || dst[j + 1] != d) hi[d - r0] = j + 1;
    }
  }
  __syncthreads();
}

// k[src] + e and v[src] + e for the lane's features of slot j of sample b
// (the tile's window at slot wm), and the slot's attributes.
template <typename S, int FPL>
__device__ __forceinline__ void load_slot(const Params<S>& p, int b, long long wm, int j,
                                          int start, const float* we_s, int lane,
                                          float (&kj)[FPL], float (&vj)[FPL],
                                          float (&at)[kMaxA]) {
  const int HD = p.H * p.D;
  const int sr = p.src_rel[wm + j];
  const int src = start + sr;
  const bool ok = sr >= 0 && sr < p.SW && src < p.n_max;
  const long long row = (static_cast<long long>(b) * p.n_max + (ok ? src : 0)) * HD;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) at[a] = a < p.A ? p.attr[(wm + j) * p.A + a] : 0.f;
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    kj[i] = 0.f;
    vj[i] = 0.f;
    if (f < HD) {
      float e = 0.f;
#pragma unroll
      for (int a = 0; a < kMaxA; ++a)
        if (a < p.A) e = fmaf(at[a], we_s[a * HD + f], e);
      kj[i] = (ok ? to_f(p.k[row + f]) : 0.f) + e;
      vj[i] = (ok ? to_f(p.v[row + f]) : 0.f) + e;
    }
  }
}

// head[h] = mult * sum of buf's D entries of head h (and head2 from buf2
// when given), lanes over heads. Warp-synchronous on both sides.
__device__ __forceinline__ void head_sums(const float* buf, float* head, const float* buf2,
                                          float* head2, int H, int D, float mult, int lane) {
  __syncwarp();
  for (int h = lane; h < H; h += 32) {
    float s = 0.f, s2 = 0.f;
    for (int x = 0; x < D; ++x) {
      s += buf[h * D + x];
      if (buf2 != nullptr) s2 += buf2[h * D + x];
    }
    head[h] = s * mult;
    if (head2 != nullptr) head2[h] = s2;
  }
  __syncwarp();
}

template <typename S>
__device__ __forceinline__ float keep_at(const Params<S>& p, const float* keep, int h, int j) {
  return keep != nullptr ? keep[static_cast<long long>(min(h, p.KH - 1)) * p.EB + j] : 1.f;
}

template <typename S, int FPL>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(Params<S> p) {
  extern __shared__ float smem[];
  __shared__ int lo[kMaxRows], hi[kMaxRows];
  const int groups = (p.NT + p.rows - 1) / p.rows;
  const int t = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * p.rows;
  const int b = blockIdx.y;
  const int mb = b * p.mstride;  // the sample's mesh
  const int HD = p.H * p.D;
  const int AHD = p.A * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_end = min(r0 + p.rows, p.NT);
  float* part = p.dwe_part + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * AHD;

  if (t >= p.live[mb]) {  // dead tile: zero dq rows and this CTA's dWe partial
    for (int r = r0 + warp; r < r_end; r += kWarps) {
      const int node = t * p.NT + r;
      if (node >= p.n_max) break;
      S* o = p.out + (static_cast<long long>(b) * p.n_max + node) * HD;
      for (int f = lane; f < HD; f += 32) o[f] = from_f<S>(0.f);
    }
    for (int i = threadIdx.x; i < AHD; i += blockDim.x) part[i] = 0.f;
    return;
  }
  float* we_s = smem;                                          // A * HD
  float* buf = smem + AHD + warp * (2 * HD + 2 * p.H);         // per warp: HD
  float* buf2 = buf + HD;                                      // HD
  float* head = buf2 + HD;                                     // H
  float* head2 = head + p.H;                                   // H
  float* red = smem + AHD + kWarps * (2 * HD + 2 * p.H);       // kWarps * A * HD
  for (int i = threadIdx.x; i < AHD; i += blockDim.x) we_s[i] = to_f(p.we[i]);
  const long long w = (static_cast<long long>(b) * p.T + t) * p.EB;    // the sample's slots
  const long long wm = (static_cast<long long>(mb) * p.T + t) * p.EB;  // its mesh's window
  scan_rows(p, wm, r0, lo, hi);
  const int start = p.s0[mb * p.T + t];
  const float* keep =
      p.keep != nullptr ? p.keep + (static_cast<long long>(b) * p.T + t) * p.KH * p.EB : nullptr;

  float dwe[kMaxA][FPL];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a)
#pragma unroll
    for (int i = 0; i < FPL; ++i) dwe[a][i] = 0.f;

  for (int r = r0 + warp; r < r_end; r += kWarps) {
    const int node = t * p.NT + r;
    if (node >= p.n_max) break;  // uniform across the warp
    const long long row = (static_cast<long long>(b) * p.n_max + node) * HD;
    float qf[FPL], gf[FPL], m[FPL], den[FPL], rowdot[FPL], dq[FPL];
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      qf[i] = f < HD ? to_f(p.q[row + f]) : 0.f;
      gf[i] = f < HD ? to_f(p.g[row + f]) : 0.f;
      m[i] = -INFINITY;
      den[i] = 0.f;
      rowdot[i] = 0.f;
      dq[i] = 0.f;
    }
    const int j0 = lo[r - r0], j1 = hi[r - r0];
    // pass 1: max, denominator and sum_j p_j * dalpha_j (online)
    for (int j = j0; j < j1; ++j) {
      float kj[FPL], vj[FPL], at[kMaxA];
      load_slot<S, FPL>(p, b, wm, j, start, we_s, lane, kj, vj, at);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        const int f = lane + 32 * i;
        if (f < HD) {
          buf[f] = qf[i] * kj[i];
          buf2[f] = gf[i] * vj[i];
        }
      }
      head_sums(buf, head, buf2, head2, p.H, p.D, p.scale, lane);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        const int f = lane + 32 * i;
        if (f < HD) {
          const int h = f / p.D;
          const float s = head[h];
          const float da = keep_at(p, keep, h, j) * head2[h];
          const float mn = fmaxf(m[i], s);
          const float corr = expf(m[i] - mn);
          const float pe = expf(s - mn);
          den[i] = den[i] * corr + pe;
          rowdot[i] = rowdot[i] * corr + pe * da;
          m[i] = mn;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      den[i] = fmaxf(den[i], 1e-30f);
      rowdot[i] = rowdot[i] / den[i];
    }
    // pass 2: alpha, dlogit; dq, the slot partials and dWe
    for (int j = j0; j < j1; ++j) {
      float kj[FPL], vj[FPL], at[kMaxA];
      load_slot<S, FPL>(p, b, wm, j, start, we_s, lane, kj, vj, at);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        const int f = lane + 32 * i;
        if (f < HD) {
          buf[f] = qf[i] * kj[i];
          buf2[f] = gf[i] * vj[i];
        }
      }
      head_sums(buf, head, buf2, head2, p.H, p.D, p.scale, lane);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        const int f = lane + 32 * i;
        if (f < HD) {
          const int h = f / p.D;
          const float kp = keep_at(p, keep, h, j);
          const float alpha = expf(head[h] - m[i]) / den[i];
          const float dlg = alpha * (kp * head2[h] - rowdot[i]) * p.scale;
          dq[i] = fmaf(dlg, kj[i], dq[i]);
          const float dks = dlg * qf[i];
          const float dvs = alpha * kp * gf[i];
          if (f % p.D == 0) {  // the head's first lane parks its scalars
            p.dlog[(w + j) * p.H + h] = dlg;
            p.used[(w + j) * p.H + h] = alpha * kp;
          }
#pragma unroll
          for (int a = 0; a < kMaxA; ++a) dwe[a][i] = fmaf(at[a], dks + dvs, dwe[a][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      if (f < HD) p.out[row + f] = from_f<S>(dq[i]);
    }
  }
  // dWe: the CTA's warps summed in warp order (a fixed tree)
#pragma unroll
  for (int a = 0; a < kMaxA; ++a)
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      if (a < p.A && f < HD) red[(warp * p.A + a) * HD + f] = dwe[a][i];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < AHD; i += blockDim.x) {
    float s = 0.f;
    for (int x = 0; x < kWarps; ++x) s += red[x * AHD + i];
    part[i] = s;
  }
}

// K4, second kernel: the owner of source node s gathers
//   dk[s] = sum_j dlog_j,h * q[dst_j],  dv[s] = sum_j used_j,h * g[dst_j]
// over the slots j whose source is s, in ascending slot order, through the
// source-sorted view (of the sample's mesh: one view for the batch on a
// shared mesh). LPR lanes a row (HD rounded up to a power of two, at most
// 32), so at HD 1 a warp owns 32 rows.
constexpr int kSrcThreads = 256;
constexpr int kPerLane = 4;  // features a lane accumulates per pass over a row

template <typename S, int LPR>
__global__ void __launch_bounds__(kSrcThreads) attn_bwd_src_kernel(Params<S> p, int B) {
  const long long thread = static_cast<long long>(blockIdx.x) * kSrcThreads + threadIdx.x;
  const long long row = thread / LPR;
  const int sub = static_cast<int>(thread % LPR);
  if (row >= static_cast<long long>(B) * p.n_max) return;
  const int b = static_cast<int>(row / p.n_max);
  const int mb = b * p.mstride;
  const int n = static_cast<int>(row - static_cast<long long>(b) * p.n_max);
  const int HD = p.H * p.D;
  const long long L = static_cast<long long>(p.T) * p.EB;
  const int* off = p.offsets + static_cast<long long>(mb) * (p.n_max + 1) + n;
  const int start = off[0], end = off[1];
  for (int f0 = 0; f0 < HD; f0 += LPR * kPerLane) {
    float dk[kPerLane], dv[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    for (int j = start; j < end; ++j) {
      const long long e = p.order[j];  // mb * L + t * EB + slot
      const long long slot = e - mb * L;
      const int t = static_cast<int>(slot / p.EB);
      const long long drow = (static_cast<long long>(b) * p.n_max + t * p.NT + p.dst_rel[e]) * HD;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int f = f0 + sub + i * LPR;
        if (f < HD) {
          const long long at = (b * L + slot) * p.H + f / p.D;
          dk[i] = fmaf(p.dlog[at], to_f(p.q[drow + f]), dk[i]);
          dv[i] = fmaf(p.used[at], to_f(p.g[drow + f]), dv[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int f = f0 + sub + i * LPR;
      if (f < HD) {
        p.dk[row * HD + f] = from_f<S>(dk[i]);
        p.dv[row * HD + f] = from_f<S>(dv[i]);
      }
    }
  }
}

template <typename S, int LPR>
cudaError_t launch_src(const Params<S>& p, int B, cudaStream_t stream) {
  const long long threads = static_cast<long long>(B) * p.n_max * LPR;
  const unsigned blocks = static_cast<unsigned>((threads + kSrcThreads - 1) / kSrcThreads);
  attn_bwd_src_kernel<S, LPR><<<blocks, kSrcThreads, 0, stream>>>(p, B);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_src_width(const Params<S>& p, int B, cudaStream_t s) {
  const int HD = p.H * p.D;
  if (HD >= 32) return launch_src<S, 32>(p, B, s);
  if (HD > 8) return launch_src<S, 16>(p, B, s);
  if (HD > 4) return launch_src<S, 8>(p, B, s);
  if (HD > 2) return launch_src<S, 4>(p, B, s);
  if (HD == 2) return launch_src<S, 2>(p, B, s);
  return launch_src<S, 1>(p, B, s);
}

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
  int* start = reinterpret_cast<int*>(fsm);  // rows + 1, then the group's slot range
  const int* dst = reinterpret_cast<const int*>(fsm + fwd_pad4(p.rows + 3));
  const int* src = dst + fwd_pad4(p.EB);
  const float* at = reinterpret_cast<const float*>(src + fwd_pad4(p.EB));  // EB * A
  __syncthreads();  // the previous group's readers of shared memory are done
  // 1. the tile's window in one round trip
  const int first = __ldg(p.s0 + mtile);
  stage_tile(p, mtile, fsm);
  __syncthreads();
  // 2. start[i]: the first slot whose destination is at or past row r0 + i;
  // warp 0 (and 1) find the group's range, then the CTA scans only that
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

template <typename S>
bool bad_geometry(const Params<S>& p) {
  return p.rows < 1 || p.rows > kMaxRows || p.A < 1 || p.A > kMaxA || p.H < 1 || p.D < 1 ||
         p.KH < 0 || p.KH > p.H || (p.KH == 0) != (p.keep == nullptr) || p.NT < 1 ||
         p.H * p.D > 512;
}

template <typename S, int FPL>
cudaError_t launch(const Params<S>& p, int B, cudaStream_t stream) {
  const int HD = p.H * p.D;
  const dim3 grid(p.T * ((p.NT + p.rows - 1) / p.rows), B);
  const size_t smem =
      sizeof(float) * (p.A * HD + kWarps * (2 * HD + 2 * p.H) + kWarps * p.A * HD);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<S, FPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  attn_bwd_kernel<S, FPL><<<grid, kThreads, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_src_width(p, B, stream);
}

template <typename S>
int dispatch(const Params<S>& p, int B, void* stream) {
  if (bad_geometry(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || p.T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fpl = (p.H * p.D + 31) / 32;
  cudaError_t err;
  if (fpl <= 1) err = launch<S, 1>(p, B, s);
  else if (fpl <= 2) err = launch<S, 2>(p, B, s);
  else if (fpl <= 4) err = launch<S, 4>(p, B, s);
  else if (fpl <= 8) err = launch<S, 8>(p, B, s);
  else err = launch<S, 16>(p, B, s);
  return static_cast<int>(err);
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
  if (B < 0 || (meta_b != B && meta_b != 1) || T < 0 || EB < 1 || NT < 1 || n_max < 1 ||
      A < 1 || A > kMaxA || H < 1 ||
      D < 1 || H * D > 512 || KH < 0 || KH > H || (KH == 0) != (keep == nullptr) ||
      !fwd_instance(run, chunk) || !pow2(lanes_head) ||
      lanes_head > 32 || lanes_head * run < D || heads_item < 1 || !pow2(lanes_item) ||
      lanes_item > 32 || heads_item * lanes_head > lanes_item || slices < 1 ||
      slices * heads_item < H || warps < 1 || warps > kFwdMaxWarps || rows < 1 || rows > NT ||
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

template <typename S>
int attn_bwd(const S* q, const S* k, const S* v, const S* we, const float* keep, const int* s0,
             const int* src_rel, const int* dst_rel, const float* attr, const int* live,
             const S* g, const int* order, const int* offsets, S* dq, S* dk, S* dv, float* dlog,
             float* used, float* dwe_part, int B, int meta_b, int T, int EB, int NT, int SW,
             int n_max, int H, int D, int A, int KH, int rows, float scale, void* stream) {
  if (meta_b != B && meta_b != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params<S> p{q,    k,        v,     we,      keep, s0, src_rel, dst_rel, attr, live,
                    g,    dq,       dlog,  used,    dwe_part, order, offsets, dk, dv, T,
                    EB,   NT,       SW,    n_max,   H,    D,  A,       KH,      rows, scale,
                    meta_b == B ? 1 : 0};
  return dispatch(p, B, stream);
}

}  // namespace

// run .. chunk: K3's plan (ops/attn.py fwd_plan). geometry, when not null,
// is a host array of 8 ints that receives what was launched: CTAs, row
// groups, threads a CTA, shared bytes, run, chunk, 16-byte rows, 16-byte
// window copies.
extern "C" int qtm_attn_fwd(const float* q, const float* k, const float* v, const float* we,
                            const float* keep, const int* s0, const int* src_rel,
                            const int* dst_rel, const float* attr, const int* live, float* out,
                            int B, int meta_b, int T, int EB, int NT, int SW, int n_max, int H,
                            int D, int A, int KH, int run, int lanes_head, int heads_item,
                            int lanes_item, int slices, int warps, int rows, int chunk,
                            float scale, void* stream, int* geometry) {
  return attn_fwd<float>(q, k, v, we, keep, s0, src_rel, dst_rel, attr, live, out, B, meta_b, T,
                         EB, NT, SW, n_max, H, D, A, KH, run, lanes_head, heads_item, lanes_item,
                         slices, warps, rows, chunk, scale, stream, geometry);
}

// the same with q, k, v, We and out in bf16 (keep and attr stay f32)
extern "C" int qtm_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* we,
                                 const float* keep, const int* s0, const int* src_rel,
                                 const int* dst_rel, const float* attr, const int* live, void* out,
                                 int B, int meta_b, int T, int EB, int NT, int SW, int n_max,
                                 int H, int D, int A, int KH, int run, int lanes_head,
                                 int heads_item, int lanes_item, int slices, int warps, int rows,
                                 int chunk, float scale, void* stream, int* geometry) {
  return attn_fwd<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<const bf16*>(we), keep, s0,
                        src_rel, dst_rel, attr, live, static_cast<bf16*>(out), B, meta_b, T, EB,
                        NT, SW, n_max, H, D, A, KH, run, lanes_head, heads_item, lanes_item,
                        slices, warps, rows, chunk, scale, stream, geometry);
}

// order (M*T*EB) and offsets (M, n_max + 1): the source-sorted slot view
// (ops/attn.py slot_view) of the M = meta_b meshes (B, or 1 for a shared
// mesh, as the windows); dlog and used (B, T*EB, H) scratch.
extern "C" int qtm_attn_bwd(const float* q, const float* k, const float* v, const float* we,
                            const float* keep, const int* s0, const int* src_rel,
                            const int* dst_rel, const float* attr, const int* live,
                            const float* g, const int* order, const int* offsets, float* dq,
                            float* dk, float* dv, float* dlog, float* used, float* dwe_part,
                            int B, int meta_b, int T, int EB, int NT, int SW, int n_max, int H,
                            int D, int A, int KH, int rows, float scale, void* stream) {
  return attn_bwd<float>(q, k, v, we, keep, s0, src_rel, dst_rel, attr, live, g, order, offsets,
                         dq, dk, dv, dlog, used, dwe_part, B, meta_b, T, EB, NT, SW, n_max, H, D,
                         A, KH, rows, scale, stream);
}

// the same with q, k, v, We, g, dq, dk and dv in bf16 (keep, attr, dlog,
// used and the dWe partials stay f32)
extern "C" int qtm_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* we,
                                 const float* keep, const int* s0, const int* src_rel,
                                 const int* dst_rel, const float* attr, const int* live,
                                 const void* g, const int* order, const int* offsets, void* dq,
                                 void* dk, void* dv, float* dlog, float* used, float* dwe_part,
                                 int B, int meta_b, int T, int EB, int NT, int SW, int n_max,
                                 int H, int D, int A, int KH, int rows, float scale,
                                 void* stream) {
  const auto in = [](const void* x) { return static_cast<const bf16*>(x); };
  const auto out = [](void* x) { return static_cast<bf16*>(x); };
  return attn_bwd<bf16>(in(q), in(k), in(v), in(we), keep, s0, src_rel, dst_rel, attr, live,
                        in(g), order, offsets, out(dq), out(dk), out(dv), dlog, used, dwe_part, B,
                        meta_b, T, EB, NT, SW, n_max, H, D, A, KH, rows, scale, stream);
}
