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
// _apply_kernel). out[t*NT + r, f] = sum_s blocks[t][r][s] * z[s0[t] + s, f]
// as a shared-memory tiled f32 FMA product per (sample, tile, 64-row slab,
// 32-column chunk of F), accumulated in f32 with no TF32, as the TPU
// kernel runs f32 at Precision.HIGHEST. Rows of the source window at or
// past n_max read as zero inside the kernel, so z is not padded, and F is
// masked, not padded. Bound: at F = 128 the FMAs (2*NT*SW*F a live tile
// against 67 TFLOP/s of f32 outside the tensor cores); at narrower F the
// bytes of the Â block. Dead tiles write zeros without reading the block.
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

constexpr int kBM = 64;  // output rows per CTA
constexpr int kBN = 32;  // output columns (features) per CTA
constexpr int kBK = 32;  // source rows per shared-memory stage
constexpr int kApplyThreads = 256;  // 16 x 16 threads, 4 x 2 outputs each

__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const float* __restrict__ z, const float* __restrict__ blocks,
             const int* __restrict__ s0, const int* __restrict__ live,
             float* __restrict__ out, int T, int NT, int SW, int n_max, int F) {
  __shared__ float As[kBM][kBK + 1];
  __shared__ float Bs[kBK][kBN];

  const int fchunks = (F + kBN - 1) / kBN;
  const int f0 = (blockIdx.x % fchunks) * kBN;
  const int r0 = (blockIdx.x / fchunks) * kBM;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns f0 + 2*tx + {0, 1}
  const int ty = tid / 16;  // rows r0 + 4*ty + {0..3}

  float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  if (t < live[b]) {  // uniform across the CTA
    const float* A = blocks + (static_cast<long long>(b) * T + t) * NT * SW;
    const float* Z = z + static_cast<long long>(b) * n_max * F;
    const int start = s0[b * T + t];
    for (int k0 = 0; k0 < SW; k0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kApplyThreads) {
        const int r = i / kBK, k = i % kBK;
        const int gr = r0 + r, gk = k0 + k;
        As[r][k] = (gr < NT && gk < SW) ? A[static_cast<long long>(gr) * SW + gk] : 0.f;
      }
      for (int i = tid; i < kBK * kBN; i += kApplyThreads) {
        const int k = i / kBN, c = i % kBN;
        const int zr = start + k0 + k, gc = f0 + c;
        Bs[k][c] = (k0 + k < SW && zr < n_max && gc < F)
                       ? Z[static_cast<long long>(zr) * F + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[4], v[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][k];
#pragma unroll
        for (int j = 0; j < 2; ++j) v[j] = Bs[k][tx * 2 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    const int gr = t * NT + r;
    if (r >= NT || gr >= n_max) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = f0 + tx * 2 + j;
      if (c < F) out[(static_cast<long long>(b) * n_max + gr) * F + c] = acc[i][j];
    }
  }
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

extern "C" int qtm_spmm_apply(const float* z, const float* blocks, const int* s0,
                              const int* live, float* out, int B, int T, int NT, int SW,
                              int n_max, int F, void* stream) {
  const int fchunks = (F + kBN - 1) / kBN;
  const int slabs = (NT + kBM - 1) / kBM;
  const dim3 grid(fchunks * slabs, T, B);
  apply_kernel<<<grid, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, blocks, s0, live, out, T, NT, SW, n_max, F);
  return static_cast<int>(cudaGetLastError());
}
