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
// the window slots are dst-sorted (window_geometry), so each destination's
// slots are one contiguous range, found by a scan of the tile's dst_rel in
// every CTA. One CTA serves 16 destination rows of one (sample, tile), one
// warp one row at a time, with the lanes over the HD features (lane l holds
// features l, l + 32, ...; a ragged HD, down to 1, is masked, not padded).
// Per slot a warp reads the source's k and v rows (coalesced) and the
// slot's attributes; per-head dot products are summed through a small
// per-warp shared-memory buffer. K3 runs an online softmax in f32 (running
// max, running sum and the accumulator of p * keep * (v + e)); a row with
// no slot gives 0, as the TPU kernel's clamp of the denominator does.
//
// K4 runs in two kernels with no float atomics, so a backward is
// bit-reproducible. The first recomputes the row's max and denominator and
// the row dot sum_j alpha_j * dalpha_j in a first pass over the slots, then
// in a second pass forms dlogit = alpha * (dalpha - rowdot) and writes
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
// Bound: both kernels are bound by bytes. Per live slot they read a k and
// a v row (8*HD bytes; K4 also reads q and g rows again per source slot)
// against about 2*A*HD + 4*HD operations (K4 about twice that), far below
// the card's 20 operations per byte of f32. What this simple design leaves
// on the table (16-row CTAs on few live tiles, serial per-row slot loops,
// idle lanes at HD < 32 in the first kernel) is a later PR's work.
//
// Slots that are dead (dst_rel = -1), in dead tiles (t >= live[b]), or that
// reach a padding row at or past n_max are skipped; a source outside the
// window or past n_max reads a zero k/v row, as in the TPU kernel. Every
// output row below n_max is written. Both kernels take a leading batch
// axis, launch on the caller's stream, do not synchronise and allocate
// nothing; each entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a geometry it does not take) so that the
// Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 32;  // destination rows per CTA (the wrapper passes 16)
constexpr int kMaxA = 4;      // edge-attribute columns

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* we;
  const float* keep;  // (B, T, KH, EB) or null (no dropout)
  const int* s0;
  const int* src_rel;
  const int* dst_rel;
  const float* attr;
  const int* live;
  const float* g;     // K4: the cotangent
  float* out;         // K3: out; K4: dq
  float* dlog;        // K4: (B, T*EB, H) dlogit * scale per slot and head
  float* used;        // K4: (B, T*EB, H) alpha * keep per slot and head
  float* dwe_part;    // K4: (B, T*groups, A, HD)
  const int* order;   // K4: (B*T*EB) slots by source node (the source-sorted view)
  const int* offsets; // K4: (B, n_max + 1) slot ranges of the source nodes
  float* dk;          // K4: (B, n_max, HD)
  float* dv;
  int T, EB, NT, SW, n_max, H, D, A, KH, rows;
  float scale;
};

// Row ranges [lo, hi) of the slots of rows r0 .. r0 + rows of one tile
// window (dst-sorted, so each row's slots are contiguous); rows without a
// slot keep lo = hi = 0. Ends with the CTA synchronised.
__device__ __forceinline__ void scan_rows(const Params& p, long long w, int r0, int* lo,
                                          int* hi) {
  for (int i = threadIdx.x; i < p.rows; i += blockDim.x) {
    lo[i] = 0;
    hi[i] = 0;
  }
  __syncthreads();
  const int* dst = p.dst_rel + w;
  for (int j = threadIdx.x; j < p.EB; j += blockDim.x) {
    const int d = dst[j];
    if (d >= r0 && d < r0 + p.rows) {
      if (j == 0 || dst[j - 1] != d) lo[d - r0] = j;
      if (j == p.EB - 1 || dst[j + 1] != d) hi[d - r0] = j + 1;
    }
  }
  __syncthreads();
}

// k[src] + e and v[src] + e for the lane's features of slot j, and the
// slot's attributes.
template <int FPL>
__device__ __forceinline__ void load_slot(const Params& p, int b, long long w, int j, int start,
                                          const float* we_s, int lane, float (&kj)[FPL],
                                          float (&vj)[FPL], float (&at)[kMaxA]) {
  const int HD = p.H * p.D;
  const int sr = p.src_rel[w + j];
  const int src = start + sr;
  const bool ok = sr >= 0 && sr < p.SW && src < p.n_max;
  const long long row = (static_cast<long long>(b) * p.n_max + (ok ? src : 0)) * HD;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) at[a] = a < p.A ? p.attr[(w + j) * p.A + a] : 0.f;
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
      kj[i] = (ok ? p.k[row + f] : 0.f) + e;
      vj[i] = (ok ? p.v[row + f] : 0.f) + e;
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

__device__ __forceinline__ float keep_at(const Params& p, const float* keep, int h, int j) {
  return keep != nullptr ? keep[static_cast<long long>(min(h, p.KH - 1)) * p.EB + j] : 1.f;
}

template <int FPL>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ int lo[kMaxRows], hi[kMaxRows];
  const int groups = (p.NT + p.rows - 1) / p.rows;
  const int t = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * p.rows;
  const int b = blockIdx.y;
  const int HD = p.H * p.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_end = min(r0 + p.rows, p.NT);

  if (t >= p.live[b]) {  // dead tile: zero rows; uniform across the CTA
    for (int r = r0 + warp; r < r_end; r += kWarps) {
      const int node = t * p.NT + r;
      if (node >= p.n_max) break;
      float* o = p.out + (static_cast<long long>(b) * p.n_max + node) * HD;
      for (int f = lane; f < HD; f += 32) o[f] = 0.f;
    }
    return;
  }
  float* we_s = smem;                                  // A * HD
  float* buf = smem + p.A * HD + warp * (HD + p.H);    // HD per warp
  float* head = buf + HD;                              // H per warp
  for (int i = threadIdx.x; i < p.A * HD; i += blockDim.x) we_s[i] = p.we[i];
  const long long w = (static_cast<long long>(b) * p.T + t) * p.EB;
  scan_rows(p, w, r0, lo, hi);
  const int start = p.s0[b * p.T + t];
  const float* keep =
      p.keep != nullptr ? p.keep + (static_cast<long long>(b) * p.T + t) * p.KH * p.EB : nullptr;

  for (int r = r0 + warp; r < r_end; r += kWarps) {
    const int node = t * p.NT + r;
    if (node >= p.n_max) break;  // uniform across the warp
    const long long row = (static_cast<long long>(b) * p.n_max + node) * HD;
    float qf[FPL], acc[FPL], m[FPL], l[FPL];
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      qf[i] = f < HD ? p.q[row + f] : 0.f;
      acc[i] = 0.f;
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int j = lo[r - r0]; j < hi[r - r0]; ++j) {
      float kj[FPL], vj[FPL], at[kMaxA];
      load_slot<FPL>(p, b, w, j, start, we_s, lane, kj, vj, at);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        const int f = lane + 32 * i;
        if (f < HD) buf[f] = qf[i] * kj[i];
      }
      head_sums(buf, head, nullptr, nullptr, p.H, p.D, p.scale, lane);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        const int f = lane + 32 * i;
        if (f < HD) {
          const int h = f / p.D;
          const float s = head[h];
          const float mn = fmaxf(m[i], s);
          const float corr = expf(m[i] - mn);
          const float pe = expf(s - mn);
          l[i] = l[i] * corr + pe;
          acc[i] = acc[i] * corr + pe * keep_at(p, keep, h, j) * vj[i];
          m[i] = mn;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      if (f < HD) p.out[row + f] = acc[i] / fmaxf(l[i], 1e-30f);
    }
  }
}

template <int FPL>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ int lo[kMaxRows], hi[kMaxRows];
  const int groups = (p.NT + p.rows - 1) / p.rows;
  const int t = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * p.rows;
  const int b = blockIdx.y;
  const int HD = p.H * p.D;
  const int AHD = p.A * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_end = min(r0 + p.rows, p.NT);
  float* part = p.dwe_part + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * AHD;

  if (t >= p.live[b]) {  // dead tile: zero dq rows and this CTA's dWe partial
    for (int r = r0 + warp; r < r_end; r += kWarps) {
      const int node = t * p.NT + r;
      if (node >= p.n_max) break;
      float* o = p.out + (static_cast<long long>(b) * p.n_max + node) * HD;
      for (int f = lane; f < HD; f += 32) o[f] = 0.f;
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
  for (int i = threadIdx.x; i < AHD; i += blockDim.x) we_s[i] = p.we[i];
  const long long w = (static_cast<long long>(b) * p.T + t) * p.EB;
  scan_rows(p, w, r0, lo, hi);
  const int start = p.s0[b * p.T + t];
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
      qf[i] = f < HD ? p.q[row + f] : 0.f;
      gf[i] = f < HD ? p.g[row + f] : 0.f;
      m[i] = -INFINITY;
      den[i] = 0.f;
      rowdot[i] = 0.f;
      dq[i] = 0.f;
    }
    const int j0 = lo[r - r0], j1 = hi[r - r0];
    // pass 1: max, denominator and sum_j p_j * dalpha_j (online)
    for (int j = j0; j < j1; ++j) {
      float kj[FPL], vj[FPL], at[kMaxA];
      load_slot<FPL>(p, b, w, j, start, we_s, lane, kj, vj, at);
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
      load_slot<FPL>(p, b, w, j, start, we_s, lane, kj, vj, at);
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
      if (f < HD) p.out[row + f] = dq[i];
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
// source-sorted view. LPR lanes a row (HD rounded up to a power of two, at
// most 32), so at HD 1 a warp owns 32 rows.
constexpr int kSrcThreads = 256;
constexpr int kPerLane = 4;  // features a lane accumulates per pass over a row

template <int LPR>
__global__ void __launch_bounds__(kSrcThreads) attn_bwd_src_kernel(Params p, int B) {
  const long long thread = static_cast<long long>(blockIdx.x) * kSrcThreads + threadIdx.x;
  const long long row = thread / LPR;
  const int sub = static_cast<int>(thread % LPR);
  if (row >= static_cast<long long>(B) * p.n_max) return;
  const int b = static_cast<int>(row / p.n_max);
  const int n = static_cast<int>(row - static_cast<long long>(b) * p.n_max);
  const int HD = p.H * p.D;
  const long long L = static_cast<long long>(p.T) * p.EB;
  const int* off = p.offsets + static_cast<long long>(b) * (p.n_max + 1) + n;
  const int start = off[0], end = off[1];
  for (int f0 = 0; f0 < HD; f0 += LPR * kPerLane) {
    float dk[kPerLane], dv[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    for (int j = start; j < end; ++j) {
      const long long e = p.order[j];  // b * L + t * EB + slot
      const int t = static_cast<int>((e - b * L) / p.EB);
      const long long drow = (static_cast<long long>(b) * p.n_max + t * p.NT + p.dst_rel[e]) * HD;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int f = f0 + sub + i * LPR;
        if (f < HD) {
          const long long at = e * p.H + f / p.D;
          dk[i] = fmaf(p.dlog[at], p.q[drow + f], dk[i]);
          dv[i] = fmaf(p.used[at], p.g[drow + f], dv[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int f = f0 + sub + i * LPR;
      if (f < HD) {
        p.dk[row * HD + f] = dk[i];
        p.dv[row * HD + f] = dv[i];
      }
    }
  }
}

template <int LPR>
cudaError_t launch_src(const Params& p, int B, cudaStream_t stream) {
  const long long threads = static_cast<long long>(B) * p.n_max * LPR;
  const unsigned blocks = static_cast<unsigned>((threads + kSrcThreads - 1) / kSrcThreads);
  attn_bwd_src_kernel<LPR><<<blocks, kSrcThreads, 0, stream>>>(p, B);
  return cudaGetLastError();
}

cudaError_t launch_src_width(const Params& p, int B, cudaStream_t s) {
  const int HD = p.H * p.D;
  if (HD >= 32) return launch_src<32>(p, B, s);
  if (HD > 8) return launch_src<16>(p, B, s);
  if (HD > 4) return launch_src<8>(p, B, s);
  if (HD > 2) return launch_src<4>(p, B, s);
  if (HD == 2) return launch_src<2>(p, B, s);
  return launch_src<1>(p, B, s);
}

bool bad_geometry(const Params& p) {
  return p.rows < 1 || p.rows > kMaxRows || p.A < 1 || p.A > kMaxA || p.H < 1 || p.D < 1 ||
         p.KH < 0 || p.KH > p.H || (p.KH == 0) != (p.keep == nullptr) || p.NT < 1 ||
         p.H * p.D > 512;
}

template <int FPL>
cudaError_t launch(const Params& p, int B, bool backward, cudaStream_t stream) {
  const int HD = p.H * p.D;
  const dim3 grid(p.T * ((p.NT + p.rows - 1) / p.rows), B);
  if (backward) {
    const size_t smem =
        sizeof(float) * (p.A * HD + kWarps * (2 * HD + 2 * p.H) + kWarps * p.A * HD);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          attn_bwd_kernel<FPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    attn_bwd_kernel<FPL><<<grid, kThreads, smem, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_src_width(p, B, stream);
  } else {
    const size_t smem = sizeof(float) * (p.A * HD + kWarps * (HD + p.H));
    attn_fwd_kernel<FPL><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

int dispatch(const Params& p, int B, bool backward, void* stream) {
  if (bad_geometry(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || p.T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fpl = (p.H * p.D + 31) / 32;
  cudaError_t err;
  if (fpl <= 1) err = launch<1>(p, B, backward, s);
  else if (fpl <= 2) err = launch<2>(p, B, backward, s);
  else if (fpl <= 4) err = launch<4>(p, B, backward, s);
  else if (fpl <= 8) err = launch<8>(p, B, backward, s);
  else err = launch<16>(p, B, backward, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int qtm_attn_fwd(const float* q, const float* k, const float* v, const float* we,
                            const float* keep, const int* s0, const int* src_rel,
                            const int* dst_rel, const float* attr, const int* live, float* out,
                            int B, int T, int EB, int NT, int SW, int n_max, int H, int D, int A,
                            int KH, int rows, float scale, void* stream) {
  const Params p{q,       k,       v,       we,      keep,    s0,      src_rel, dst_rel,
                 attr,    live,    nullptr, out,     nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, T,       EB,      NT,      SW,      n_max,
                 H,       D,       A,       KH,      rows,    scale};
  return dispatch(p, B, false, stream);
}

// order (B*T*EB) and offsets (B, n_max + 1): the source-sorted slot view
// (ops/attn.py slot_view); dlog and used (B, T*EB, H) scratch.
extern "C" int qtm_attn_bwd(const float* q, const float* k, const float* v, const float* we,
                            const float* keep, const int* s0, const int* src_rel,
                            const int* dst_rel, const float* attr, const int* live,
                            const float* g, const int* order, const int* offsets, float* dq,
                            float* dk, float* dv, float* dlog, float* used, float* dwe_part,
                            int B, int T, int EB, int NT, int SW, int n_max, int H, int D, int A,
                            int KH, int rows, float scale, void* stream) {
  const Params p{q,    k,        v,     we,      keep, s0, src_rel, dst_rel, attr, live,
                 g,    dq,       dlog,  used,    dwe_part, order, offsets, dk, dv, T,
                 EB,   NT,       SW,    n_max,   H,    D,  A,       KH,      rows, scale};
  return dispatch(p, B, true, stream);
}
