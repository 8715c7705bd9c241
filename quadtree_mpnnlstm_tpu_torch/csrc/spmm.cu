// Â·z over per-tile dense Â blocks on Hopper (sm_90a): kernels K1 and K2.
//
// K1 qtm_spmm_build_blocks replaces spmm_build_blocks / _build_kernel of
// quadtree_mpnnlstm_tpu/ops/pallas_spmm.py. The TPU kernel densifies a
// tile's edge window as a product of two one-hot matrices on the MXU; here
// one CTA per (sample, tile) zero-fills its (NT, SW) block with 16-byte
// stores and scatters the window's coefficients with atomicAdd. Bound: the
// bytes of the block written (512 KiB a tile at NT=128, SW=1024); the
// scatter touches at most EB entries. Dead tiles (t >= live[b]) only store
// zeros.
//
// K2 qtm_spmm_apply replaces the forward of spmm_apply (_spmm_impl /
// _apply_kernel), and K2b launches it on the cotangent (Â is symmetric).
// out[t*NT + r, f] = sum_s blocks[t][r][s] * z[s0[t] + s, f], accumulated in
// f32 with no TF32, as the TPU kernel runs f32 at Precision.HIGHEST. The
// TPU densifies Â so that its MXU can take the product; here an Â row holds
// a handful of non-zeros among SW = 1024 columns, so the kernel streams the
// block (the bytes that bound it) and does only the non-zeros' FMAs. One
// warp takes one row: 8 warps a CTA, so the 64 live tiles of the main path
// give 8192 warps, each with its row's 4 KiB in flight as 16-byte loads.
// Rows of the source window at or past n_max read as zero, so z is not
// padded. Bound: the bytes of the Â blocks of the live tiles. Dead tiles
// write zeros without reading the block.
//
// Both kernels take a leading batch axis, one mesh per sample, so one
// launch serves a whole batch. They launch on the caller's stream, do not
// synchronise and allocate nothing; each entry point returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBuildThreads = 256;

__global__ void __launch_bounds__(kBuildThreads)
build_blocks_kernel(const int* __restrict__ src_rel, const int* __restrict__ dst_rel,
                    const float* __restrict__ coeff, const int* __restrict__ live,
                    float* __restrict__ blocks, int T, int EB, int NT, int SW) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const long long tile = static_cast<long long>(b) * T + t;
  const long long n = static_cast<long long>(NT) * SW;
  float* out = blocks + tile * n;

  if ((n & 3) == 0) {  // every tile starts 16-byte aligned
    float4* out4 = reinterpret_cast<float4*>(out);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long i = threadIdx.x; i < n / 4; i += blockDim.x) out4[i] = zero;
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) out[i] = 0.f;
  }
  if (t >= live[b]) return;  // uniform across the CTA
  __syncthreads();           // zeros visible before the scatter

  const long long w = tile * EB;
  for (int e = threadIdx.x; e < EB; e += blockDim.x) {
    const int s = src_rel[w + e];
    const int d = dst_rel[w + e];
    if (s >= 0 && s < SW && d >= 0 && d < NT) {
      atomicAdd(out + static_cast<long long>(d) * SW + s, coeff[w + e]);
    }
  }
}

constexpr int kApplyWarps = 8;  // Â rows a CTA, one a warp
constexpr int kApplyThreads = 32 * kApplyWarps;
constexpr int kChunk = 128;     // columns of a row a warp reads at once, 4 a lane
constexpr int kInFlight = 8;    // chunks of a row loaded before any is used: 1024 columns
constexpr unsigned kFull = 0xffffffffu;

// K2: one warp per Â row r of a tile (t, sample b). The warp streams the
// row with 16-byte evict-first loads, kInFlight chunks at a time, and
// compacts each chunk's non-zeros in ascending column order into a list in
// shared memory (a warp scan of the lanes' counts); each lane then keeps
// FPL output features (f = f0 + lane + 32 i) and adds a * z[s0 + s, f] for
// the list's entries in order, gathering the z rows U at a time so that
// their loads overlap. Every output is one fmaf chain in ascending column
// order, as a dense sweep's: a zero entry would add a * z = +-0 and change
// nothing (for finite z), so skipping it keeps the dense result bit for
// bit. The row is read once for all of F up to 32 FPL features; wider F
// takes one pass a chunk of 32 FPL features. Dead tiles (t >= live[b])
// write zeros without reading the block; source rows at or past n_max
// read as zero.
struct ApplyParams {
  const float* z;       // (B, n_max, F)
  const float* blocks;  // (B, T, NT, SW)
  const int* s0;        // (B, T) source-window starts
  const int* live;      // (B,) live tiles
  float* out;           // (B, n_max, F)
  int T, NT, SW, n_max, F;
};

template <int FPL>
__global__ void __launch_bounds__(kApplyThreads) apply_kernel(ApplyParams p) {
  const int T = p.T, NT = p.NT, SW = p.SW, n_max = p.n_max, F = p.F;
  constexpr int U = FPL <= 4 ? 8 : 4;  // z rows gathered together
  __shared__ int list_s[kApplyWarps][kChunk];
  __shared__ float list_a[kApplyWarps][kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kApplyWarps + warp;
  const int t = blockIdx.y, b = blockIdx.z;
  const int gr = t * NT + r;
  if (r >= NT || gr >= n_max) return;  // uniform across the warp; no block barrier
  float* orow = p.out + (static_cast<long long>(b) * n_max + gr) * F;
  if (t >= p.live[b]) {
    for (int f = lane; f < F; f += 32) orow[f] = 0.f;
    return;
  }
  const float* arow = p.blocks + ((static_cast<long long>(b) * T + t) * NT + r) * SW;
  const float* Z = p.z + static_cast<long long>(b) * n_max * F;
  const int start = p.s0[b * T + t];
  const bool vec = SW % 4 == 0;  // 16-byte aligned rows
  int* ls = list_s[warp];
  float* la = list_a[warp];

  for (int f0 = 0; f0 < F; f0 += 32 * FPL) {
    float acc[FPL];
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
    int n = 0;  // entries in the list, uniform across the warp
    // acc += the list's terms in order; empties the list
    const auto flush = [&]() {
      __syncwarp();
      for (int k0 = 0; k0 < n; k0 += U) {
        float zv[U][FPL], av[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool ok = k0 + u < n;
          av[u] = ok ? la[k0 + u] : 0.f;
          const int zr = start + (ok ? ls[k0 + u] : 0);
          const bool in = ok && zr < n_max;
#pragma unroll
          for (int i = 0; i < FPL; ++i) {
            const int f = f0 + lane + 32 * i;
            zv[u][i] = in && f < F ? __ldg(Z + static_cast<long long>(zr) * F + f) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k0 + u < n) {
#pragma unroll
            for (int i = 0; i < FPL; ++i) acc[i] = fmaf(av[u], zv[u][i], acc[i]);
          }
        }
      }
      __syncwarp();
      n = 0;
    };
    for (int c0 = 0; c0 < SW; c0 += kChunk * kInFlight) {
      float4 a[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int col = c0 + j * kChunk + 4 * lane;
        if (vec) {
          a[j] = col < SW ? __ldcs(reinterpret_cast<const float4*>(arow + col))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          a[j].x = col < SW ? arow[col] : 0.f;
          a[j].y = col + 1 < SW ? arow[col + 1] : 0.f;
          a[j].z = col + 2 < SW ? arow[col + 2] : 0.f;
          a[j].w = col + 3 < SW ? arow[col + 3] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int cb = c0 + j * kChunk;
        if (cb >= SW) break;  // uniform across the warp
        const float v[4] = {a[j].x, a[j].y, a[j].z, a[j].w};
        const int cnt = (v[0] != 0.f) + (v[1] != 0.f) + (v[2] != 0.f) + (v[3] != 0.f);
        int inc = cnt;  // inclusive scan of the lanes' counts
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int x = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += x;
        }
        const int total = __shfl_sync(kFull, inc, 31);
        if (total == 0) continue;  // uniform across the warp
        if (n + total > kChunk) flush();
        int pos = n + inc - cnt;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (v[c] != 0.f) {
            ls[pos] = cb + 4 * lane + c;
            la[pos] = v[c];
            ++pos;
          }
        }
        n += total;
      }
    }
    flush();
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = f0 + lane + 32 * i;
      if (f < F) orow[f] = acc[i];
    }
  }
}

template <int FPL>
cudaError_t launch_apply(const ApplyParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.NT + kApplyWarps - 1) / kApplyWarps, p.T, B);
  apply_kernel<FPL><<<grid, kApplyThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qtm_spmm_build_blocks(const int* src_rel, const int* dst_rel, const float* coeff,
                                     const int* live, float* blocks, int B, int T, int EB,
                                     int NT, int SW, void* stream) {
  const dim3 grid(T, B);
  build_blocks_kernel<<<grid, kBuildThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src_rel, dst_rel, coeff, live, blocks, T, EB, NT, SW);
  return static_cast<int>(cudaGetLastError());
}

// fpl: output features a lane (1, 2, 4 or 8); F wider than 32 fpl takes
// one pass over the row a chunk of 32 fpl features.
extern "C" int qtm_spmm_apply(const float* z, const float* blocks, const int* s0,
                              const int* live, float* out, int B, int T, int NT, int SW,
                              int n_max, int F, int fpl, void* stream) {
  if (B < 0 || B > 65535 || T < 0 || T > 65535 || NT < 1 || SW < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  const ApplyParams p{z, blocks, s0, live, out, T, NT, SW, n_max, F};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fpl) {
    case 1: return static_cast<int>(launch_apply<1>(p, B, s));
    case 2: return static_cast<int>(launch_apply<2>(p, B, s));
    case 4: return static_cast<int>(launch_apply<4>(p, B, s));
    case 8: return static_cast<int>(launch_apply<8>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
