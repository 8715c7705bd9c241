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
// and reduces heads with one-hot matmuls. Neither is needed here: one warp
// serves one pixel, with the lanes over the H = heads * d features (lane l
// holds features l, l + 32, ...; a ragged H is masked). The D neighbour
// rows are read straight from device memory (coalesced rows; the
// neighbouring rows of nearby pixels stay in L2, so each input is read from
// memory about once). The per-head dot products are xor-shuffle butterflies
// inside aligned groups of d lanes when d divides 32, else in-order sums
// through a per-warp shared-memory buffer, so any d works, down to d = 1.
// The softmax is two-pass in f32, with the D logits kept in registers, and
// every sum runs in the order grid_attn_plain uses (ops/grid_attn.py), with
// products kept apart from sums: K5 and its plain version agree bit for bit
// on the card, so a 90-step rollout does not drift between them.
//
// K6 runs in two kernels and uses no float atomics, so a backward is
// bit-reproducible:
//   1. per destination pixel (grid_attn_bwd_dst_kernel): recompute alpha as
//      K5 does; dalpha_i = keep_i * g[p] . (v + e)_i and rowdot = sum_i
//      alpha_i * dalpha_i; then per direction dlogit_i = alpha_i * (dalpha_i
//      - rowdot) * scale and used_i = alpha_i * keep_i; write dq[p] =
//      sum_i dlogit_i (k + e)_i and the small (D, heads) planes dlog and
//      used of the pixel (zero where direction i has no edge). The CTA also
//      writes its partial of de_i = sum over the pixels of dlog_i q +
//      used_i g, its warps added in warp order; the wrapper sums the
//      partials in a fixed order;
//   2. per source pixel (grid_attn_bwd_src_kernel): gather
//      dk[s] = sum_i dlog_i[s + off_i] q[s + off_i] and
//      dv[s] = sum_i used_i[s + off_i] g[s + off_i] from the destinations
//      (r + dr, c + dc) of its D out-edges, in direction order.
//
// Bound: both are bound by bytes. K5 reads q, k, v once and writes out
// (16 * H bytes a pixel) against about 6 * H * D operations; K6 reads q, k,
// v and g and writes dq, dk and dv (28 * H bytes a pixel) against about
// 14 * H * D operations: far below the card's 20 operations per byte of
// f32. What this simple design leaves on the table (idle lanes at H < 32,
// neighbour rows read once per sweep over the directions, K6's second
// kernel reading q and g again) is a later PR's work.
//
// Column wrap: a +-1 column shift is checked on the row and the column of
// the source, so it never bleeds across a row end. The kernels take a
// leading batch axis, launch on the caller's stream, do not synchronise and
// allocate nothing; each entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a geometry it does not take) so that the Python
// wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxH = 256;        // features per pixel (8 per lane)
constexpr unsigned kFull = 0xffffffffu;

// Direction i of ops/grid.py SHIFTS_8 (the first four are SHIFTS_4).
__host__ __device__ constexpr int shift_r(int i) {
  return i == 0 ? -1 : i == 1 ? 1 : i < 4 ? 0 : (i % 2 == 0 ? -1 : 1);
}
__host__ __device__ constexpr int shift_c(int i) {
  return i < 2 ? 0 : i == 2 ? -1 : i == 3 ? 1 : i < 6 ? -1 : 1;
}

struct Params {
  const float* q;      // (B, P, H)
  const float* k;
  const float* v;
  const float* e;      // (ND, H) per-direction edge terms
  const float* valid;  // (P,) 1 = valid pixel
  const float* keep;   // (B, ND, P, heads) or null (no dropout)
  const float* g;      // K6: the cotangent (B, P, H)
  float* out;          // K5: out; K6: dq
  float* dk;           // K6 (B, P, H)
  float* dv;
  float* dlog;         // K6 scratch planes (B, ND, P, heads)
  float* used;
  float* de_part;      // K6 (B, blocks, ND, H)
  int rows, cols, heads, d;
  float scale;
};

// Source of direction i at pixel (r, c), or -1 when it lies off the grid or
// is invalid. The caller checks the pixel's own validity.
template <int I>
__device__ __forceinline__ int source(const Params& p, int r, int c) {
  const int rs = r - shift_r(I), cs = c - shift_c(I);
  if (rs < 0 || rs >= p.rows || cs < 0 || cs >= p.cols) return -1;
  const int src = rs * p.cols + cs;
  return p.valid[src] != 0.f ? src : -1;
}

// Destination of direction i's out-edge from pixel (r, c), or -1 off the grid.
template <int I>
__device__ __forceinline__ int destination(const Params& p, int r, int c) {
  const int rd = r + shift_r(I), cd = c + shift_c(I);
  if (rd < 0 || rd >= p.rows || cd < 0 || cd >= p.cols) return -1;
  return rd * p.cols + cd;
}

// The switches fold to one case once the loops over the directions are
// unrolled.
__device__ __forceinline__ int source_of(const Params& p, int dir, int r, int c) {
  switch (dir) {
    case 0: return source<0>(p, r, c);
    case 1: return source<1>(p, r, c);
    case 2: return source<2>(p, r, c);
    case 3: return source<3>(p, r, c);
    case 4: return source<4>(p, r, c);
    case 5: return source<5>(p, r, c);
    case 6: return source<6>(p, r, c);
    default: return source<7>(p, r, c);
  }
}

__device__ __forceinline__ int destination_of(const Params& p, int dir, int r, int c) {
  switch (dir) {
    case 0: return destination<0>(p, r, c);
    case 1: return destination<1>(p, r, c);
    case 2: return destination<2>(p, r, c);
    case 3: return destination<3>(p, r, c);
    case 4: return destination<4>(p, r, c);
    case 5: return destination<5>(p, r, c);
    case 6: return destination<6>(p, r, c);
    default: return destination<7>(p, r, c);
  }
}

// s[i] (the lane's features' products) := the sum over the d features of
// each feature's head, identical on every lane of the head. When d divides
// 32 a head is an aligned group of d lanes of one chunk, summed by an
// xor butterfly: a pairwise tree over adjacent features. Otherwise one lane
// per head sums its d features in order through a per-warp shared-memory
// buffer. ops/grid_attn.py grid_attn_plain sums in the same two orders, and
// the __f*_rn intrinsics keep the compiler from fusing a product into a
// sum, so that K5 and its plain version agree bit for bit.
template <int FPL>
__device__ __forceinline__ void head_sums(float (&s)[FPL], float* buf, const Params& p, int H,
                                          int lane) {
  if (32 % p.d == 0) {
#pragma unroll
    for (int i = 0; i < FPL; ++i)
      for (int o = 1; o < p.d; o <<= 1) s[i] = __fadd_rn(s[i], __shfl_xor_sync(kFull, s[i], o));
    return;
  }
  float* head = buf + H;
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    if (f < H) buf[f] = s[i];
  }
  __syncwarp();
  for (int h = lane; h < p.heads; h += 32) {
    float t = 0.f;
    for (int x = 0; x < p.d; ++x) t = __fadd_rn(t, buf[h * p.d + x]);
    head[h] = t;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    s[i] = f < H ? head[f / p.d] : 0.f;
  }
  __syncwarp();
}

__device__ __forceinline__ float keep_at(const Params& p, int b, int i, int nd, int pix, int h,
                                         int P) {
  return p.keep != nullptr
             ? p.keep[((static_cast<long long>(b) * nd + i) * P + pix) * p.heads + h]
             : 1.f;
}

// x[i] := (a[srow + f] + e_dir[f]) for the lane's features, 0 past H.
template <int FPL>
__device__ __forceinline__ void load_plus_e(const float* a, long long srow, const float* e_dir,
                                            int H, int lane, float (&x)[FPL]) {
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    x[i] = f < H ? __fadd_rn(a[srow + f], e_dir[f]) : 0.f;
  }
}

// The softmax of one pixel over its directions, as grid_attn_plain computes
// it: logits (scale * head sums of q * (k + e)), their max, exp(logit - max)
// and the sum of those in direction order; alpha[dir] := exp / sum (0 for a
// direction without an edge, or when no direction has one). src[dir] is the
// direction's source, -1 where it has no edge. Uniform across the warp.
template <int FPL, int ND>
__device__ __forceinline__ void softmax(const Params& p, int b, int pix, const float (&qf)[FPL],
                                        const float* e_s, float* buf, int lane,
                                        int (&src)[ND], float (&alpha)[ND][FPL]) {
  const int H = p.heads * p.d;
  const int P = p.rows * p.cols;
  const long long base = static_cast<long long>(b) * P;
  const int r = pix / p.cols, c = pix % p.cols;
  const bool self_ok = p.valid[pix] != 0.f;
  float mx[FPL], den[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    mx[i] = -INFINITY;
    den[i] = 0.f;
  }
#pragma unroll
  for (int dir = 0; dir < ND; ++dir) {
    src[dir] = self_ok ? source_of(p, dir, r, c) : -1;
    if (src[dir] < 0) continue;  // uniform across the warp
    float s[FPL];
    load_plus_e<FPL>(p.k, (base + src[dir]) * H, e_s + dir * H, H, lane, s);
#pragma unroll
    for (int i = 0; i < FPL; ++i) s[i] = __fmul_rn(qf[i], s[i]);
    head_sums<FPL>(s, buf, p, H, lane);
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      alpha[dir][i] = __fmul_rn(s[i], p.scale);  // the logit for now
      mx[i] = fmaxf(mx[i], alpha[dir][i]);
    }
  }
#pragma unroll
  for (int dir = 0; dir < ND; ++dir) {
    if (src[dir] < 0) continue;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      alpha[dir][i] = expf(__fsub_rn(alpha[dir][i], mx[i]));
      den[i] = __fadd_rn(den[i], alpha[dir][i]);
    }
  }
#pragma unroll
  for (int dir = 0; dir < ND; ++dir) {
#pragma unroll
    for (int i = 0; i < FPL; ++i)
      alpha[dir][i] = src[dir] >= 0 && den[i] != 0.f ? __fdiv_rn(alpha[dir][i], den[i]) : 0.f;
  }
}

template <int FPL, int ND>
__global__ void __launch_bounds__(kThreads) grid_attn_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int H = p.heads * p.d;
  const int P = p.rows * p.cols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  float* e_s = smem;                                  // ND * H
  float* buf = smem + ND * H + warp * (H + p.heads);  // H + heads per warp
  for (int x = threadIdx.x; x < ND * H; x += blockDim.x) e_s[x] = p.e[x];
  __syncthreads();
  const int pix = blockIdx.x * kWarps + warp;
  if (pix >= P) return;  // uniform across the warp; no block barrier follows
  const long long base = static_cast<long long>(b) * P;
  const long long row = (base + pix) * H;

  float qf[FPL], acc[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    qf[i] = f < H ? p.q[row + f] : 0.f;
    acc[i] = 0.f;
  }
  int src[ND];
  float alpha[ND][FPL];
  softmax<FPL, ND>(p, b, pix, qf, e_s, buf, lane, src, alpha);
  // out = sum over the directions, in order, of alpha * keep * (v + e)
#pragma unroll
  for (int dir = 0; dir < ND; ++dir) {
    if (src[dir] < 0) continue;  // uniform across the warp
    float vj[FPL];
    load_plus_e<FPL>(p.v, (base + src[dir]) * H, e_s + dir * H, H, lane, vj);
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      if (f < H) {
        float used = alpha[dir][i];
        if (p.keep != nullptr) used = __fmul_rn(used, keep_at(p, b, dir, ND, pix, f / p.d, P));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(used, vj[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    if (f < H) p.out[row + f] = acc[i];
  }
}

// K6, first kernel: one warp per destination pixel; the CTA's de_dir partial.
template <int FPL, int ND>
__global__ void __launch_bounds__(kThreads) grid_attn_bwd_dst_kernel(Params p) {
  extern __shared__ float smem[];
  const int H = p.heads * p.d;
  const int P = p.rows * p.cols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  float* e_s = smem;                                  // ND * H
  float* buf = smem + ND * H + warp * (H + p.heads);  // H + heads per warp
  float* red = smem + ND * H + kWarps * (H + p.heads);  // kWarps * H: the warps' de terms
  for (int x = threadIdx.x; x < ND * H; x += blockDim.x) e_s[x] = p.e[x];
  __syncthreads();
  const int pix = blockIdx.x * kWarps + warp;
  // uniform across the warp; a warp past the end stays for the CTA's
  // barriers and adds zeros to the partial
  const bool live = pix < P;
  const long long base = static_cast<long long>(b) * P;
  const long long row = (base + (live ? pix : 0)) * H;

  float qf[FPL], gf[FPL], rowdot[FPL], dq[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    qf[i] = live && f < H ? p.q[row + f] : 0.f;
    gf[i] = live && f < H ? p.g[row + f] : 0.f;
    rowdot[i] = 0.f;
    dq[i] = 0.f;
  }
  int src[ND];
  float alpha[ND][FPL];
  if (live) {
    softmax<FPL, ND>(p, b, pix, qf, e_s, buf, lane, src, alpha);
  } else {
#pragma unroll
    for (int dir = 0; dir < ND; ++dir) src[dir] = -1;
  }
  // dalpha_i = keep_i * g . (v + e)_i, one value a head, is parked in the
  // pixel's dlog plane until the second sweep replaces it with dlogit_i
  // (registers would cost the kernel its second CTA an SM);
  // rowdot = sum_i alpha_i * dalpha_i
#pragma unroll
  for (int dir = 0; dir < ND; ++dir) {
    if (src[dir] < 0) continue;  // uniform across the warp
    const long long plane = ((static_cast<long long>(b) * ND + dir) * P + pix) * p.heads;
    float gv[FPL];
    load_plus_e<FPL>(p.v, (base + src[dir]) * H, e_s + dir * H, H, lane, gv);
#pragma unroll
    for (int i = 0; i < FPL; ++i) gv[i] = gf[i] * gv[i];
    head_sums<FPL>(gv, buf, p, H, lane);
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      const float da = f < H ? keep_at(p, b, dir, ND, pix, f / p.d, P) * gv[i] : 0.f;
      rowdot[i] = fmaf(alpha[dir][i], da, rowdot[i]);
      if (f < H && f % p.d == 0) p.dlog[plane + f / p.d] = da;
    }
  }
  __syncwarp();  // the parked dalpha is visible to every lane of the warp
  // dlogit_i = alpha_i * (dalpha_i - rowdot) * scale; dq, the planes, the
  // CTA's de partial
#pragma unroll
  for (int dir = 0; dir < ND; ++dir) {
    const long long plane = ((static_cast<long long>(b) * ND + dir) * P + pix) * p.heads;
    float dl[FPL], us[FPL];
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      dl[i] = 0.f;
      us[i] = 0.f;
    }
    if (src[dir] >= 0) {  // uniform across the warp
      float kj[FPL];
      load_plus_e<FPL>(p.k, (base + src[dir]) * H, e_s + dir * H, H, lane, kj);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        const int f = lane + 32 * i;
        if (f < H) {
          const float kp = keep_at(p, b, dir, ND, pix, f / p.d, P);
          dl[i] = alpha[dir][i] * (p.dlog[plane + f / p.d] - rowdot[i]) * p.scale;
          us[i] = alpha[dir][i] * kp;
          dq[i] = fmaf(dl[i], kj[i], dq[i]);
        }
      }
      __syncwarp();  // every lane has read dalpha before it is overwritten
    }
    // the lane of each head's first feature writes the planes (zero where
    // the direction has no edge)
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      if (live && f < H && f % p.d == 0) {
        p.dlog[plane + f / p.d] = dl[i];
        p.used[plane + f / p.d] = us[i];
      }
      if (f < H) red[warp * H + f] = dl[i] * qf[i] + us[i] * gf[i];
    }
    __syncthreads();
    float* part = p.de_part + ((static_cast<long long>(b) * gridDim.x + blockIdx.x) * ND + dir) * H;
    for (int f = threadIdx.x; f < H; f += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * H + f];
      part[f] = s;
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    if (f < H) p.out[row + f] = dq[i];
  }
}

// K6, second kernel: one warp per source pixel gathers its dk and dv from
// the destinations of its out-edges.
template <int FPL, int ND>
__global__ void __launch_bounds__(kThreads) grid_attn_bwd_src_kernel(Params p) {
  const int H = p.heads * p.d;
  const int P = p.rows * p.cols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kWarps + warp;
  if (pix >= P) return;
  const long long base = static_cast<long long>(b) * P;
  const int r = pix / p.cols, c = pix % p.cols;
  float dk[FPL], dv[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
#pragma unroll
  for (int dir = 0; dir < ND; ++dir) {
    const int dst = destination_of(p, dir, r, c);
    if (dst < 0) continue;  // uniform across the warp
    // the planes are zero where the edge does not exist (either end
    // invalid), so no validity test is needed here
    const long long plane = ((static_cast<long long>(b) * ND + dir) * P + dst) * p.heads;
    const long long drow = (base + dst) * H;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      if (f < H) {
        const int h = f / p.d;
        dk[i] = fmaf(p.dlog[plane + h], p.q[drow + f], dk[i]);
        dv[i] = fmaf(p.used[plane + h], p.g[drow + f], dv[i]);
      }
    }
  }
  const long long row = (base + pix) * H;
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    if (f < H) {
      p.dk[row + f] = dk[i];
      p.dv[row + f] = dv[i];
    }
  }
}

template <int FPL, int ND>
cudaError_t launch(const Params& p, int B, bool backward, cudaStream_t stream) {
  const int H = p.heads * p.d;
  const int P = p.rows * p.cols;
  const dim3 grid((P + kWarps - 1) / kWarps, B);
  // dynamic shared memory: the edge terms and a head-sum buffer per warp
  // (laid out even when the butterflies leave it unused), and for K6 the
  // warps' de terms: at most 8 * 256 + 8 * (256 + 256) + 8 * 256 floats =
  // 32 KB, under the 48 KB default
  const size_t smem = sizeof(float) * (ND * H + static_cast<size_t>(kWarps) * (H + p.heads));
  if (!backward) {
    grid_attn_fwd_kernel<FPL, ND><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
  grid_attn_bwd_dst_kernel<FPL, ND>
      <<<grid, kThreads, smem + sizeof(float) * kWarps * H, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grid_attn_bwd_src_kernel<FPL, ND><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int ND>
cudaError_t launch_width(const Params& p, int B, bool backward, cudaStream_t s) {
  const int fpl = (p.heads * p.d + 31) / 32;
  if (fpl <= 1) return launch<1, ND>(p, B, backward, s);
  if (fpl <= 2) return launch<2, ND>(p, B, backward, s);
  if (fpl <= 4) return launch<4, ND>(p, B, backward, s);
  return launch<8, ND>(p, B, backward, s);
}

// blocks: K6's de partials a sample, one per CTA of its first kernel.
int dispatch(const Params& p, int B, int nd, int blocks, bool backward, void* stream) {
  const int P = p.rows * p.cols;
  if (p.rows < 1 || p.cols < 1 || p.heads < 1 || p.d < 1 || p.heads * p.d > kMaxH ||
      (nd != 4 && nd != 8) || B < 0 || (backward && blocks != (P + kWarps - 1) / kWarps))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      nd == 4 ? launch_width<4>(p, B, backward, s) : launch_width<8>(p, B, backward, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int qtm_grid_attn_fwd(const float* q, const float* k, const float* v, const float* e,
                                 const float* valid, const float* keep, float* out, int B,
                                 int rows, int cols, int heads, int d, int nd, float scale,
                                 void* stream) {
  const Params p{q, k, v, e, valid, keep, nullptr, out, nullptr, nullptr, nullptr, nullptr,
                 nullptr, rows, cols, heads, d, scale};
  return dispatch(p, B, nd, 0, false, stream);
}

extern "C" int qtm_grid_attn_bwd(const float* q, const float* k, const float* v, const float* e,
                                 const float* valid, const float* keep, const float* g, float* dq,
                                 float* dk, float* dv, float* dlog, float* used, float* de_part,
                                 int B, int rows, int cols, int heads, int d, int nd, int blocks,
                                 float scale, void* stream) {
  const Params p{q, k, v, e, valid, keep, g, dq, dk, dv, dlog, used, de_part,
                 rows, cols, heads, d, scale};
  return dispatch(p, B, nd, blocks, true, stream);
}
