// Â·z over per-tile dense Â blocks on Hopper (sm_90a): kernels K1 and K2,
// each in float32 and in bfloat16 storage.
//
// K1 qtm_spmm_build_blocks replaces spmm_build_blocks / _build_kernel of
// quadtree_mpnnlstm_tpu/ops/pallas_spmm.py. The TPU kernel densifies a
// tile's edge window as a product of two one-hot matrices on the MXU; here
// one CTA per (sample, tile) zero-fills its (NT, SW) block with 16-byte
// stores and scatters the window's coefficients. Bound: the bytes of the
// block written (512 KiB a tile at NT=128, SW=1024 in f32, 256 KiB in
// bf16); the scatter touches at most EB entries. Dead tiles (t >= live[b])
// only store zeros. In f32 the scatter adds with atomicAdd. In bf16
// (qtm_spmm_build_blocks_bf16, the TPU kernel's block_dtype) an entry is
// the f32 sum of its coefficients rounded once, as the TPU kernel rounds
// its f32 product: the slot that holds the first (dst, src) of its
// destination's run of the dst-sorted window sums that run's slots with the
// same source in slot order and stores the sum; no bf16 atomics.
//
// K2 qtm_spmm_apply replaces the forward of spmm_apply (_spmm_impl /
// _apply_kernel), and K2b launches it on the cotangent (Â is symmetric).
// out[t*NT + r, f] = sum_s blocks[t][r][s] * z[s0[t] + s, f], accumulated in
// f32 with no TF32, as the TPU kernel runs f32 at Precision.HIGHEST. The
// TPU densifies Â so that its MXU can take the product; here an Â row holds
// a handful of non-zeros among SW = 1024 columns, so the kernel streams the
// block (the bytes that bound it) and does only the non-zeros' FMAs. One
// warp takes one row: 8 warps a CTA, so the 64 live tiles of the main path
// give 8192 warps, each with its row's 1024 columns in flight as 16-byte
// loads (4 KiB in f32, 2 KiB in bf16). Rows of the source window at or past
// n_max read as zero, so z is not padded. Bound: the bytes of the Â blocks
// of the live tiles. Dead tiles write zeros without reading the block. The
// bf16 path (qtm_spmm_apply_bf16) takes bf16 blocks and z, as the TPU
// kernel's bf16 operands, reads the block as 8 values in 16 bytes and z as
// bf16 pairs in 4 bytes where a lane keeps two or more features (one bf16
// at F <= 32, as in f32: a lane's pair there left three quarters of the
// warp idle and took 1.3x the f32 kernel's time), multiplies and adds in
// f32 (a bf16 product is exact in f32) and rounds each output once on the
// store.
//
// Both kernels take a leading batch axis, one mesh per sample, so one
// launch serves a whole batch. They launch on the caller's stream, do not
// synchronise and allocate nothing; each entry point returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// Storage types: float and bf16, converted to and from the f32 arithmetic
// with the intrinsics. kVec values fill 16 bytes.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  // the kVec values of the 16 bytes at p, streamed (evict first)
  static __device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct Elem<bf16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ bf16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

constexpr int kBuildThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBuildThreads)
build_blocks_kernel(const int* __restrict__ src_rel, const int* __restrict__ dst_rel,
                    const float* __restrict__ coeff, const int* __restrict__ live,
                    T* __restrict__ blocks, int T_, int EB, int NT, int SW) {
  constexpr int V = Elem<T>::kVec;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const long long tile = static_cast<long long>(b) * T_ + t;
  const long long n = static_cast<long long>(NT) * SW;
  T* out = blocks + tile * n;

  if (n % V == 0) {  // every tile starts 16-byte aligned
    uint4* out16 = reinterpret_cast<uint4*>(out);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = threadIdx.x; i < n / V; i += blockDim.x) out16[i] = zero;
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) out[i] = Elem<T>::from_f(0.f);
  }
  if (t >= live[b]) return;  // uniform across the CTA
  __syncthreads();           // zeros visible before the scatter

  const long long w = tile * EB;
  for (int e = threadIdx.x; e < EB; e += blockDim.x) {
    const int s = src_rel[w + e];
    const int d = dst_rel[w + e];
    if (s < 0 || s >= SW || d < 0 || d >= NT) continue;
    if constexpr (std::is_same<T, float>::value) {
      atomicAdd(out + static_cast<long long>(d) * SW + s, coeff[w + e]);
    } else {
      // the window is dst-sorted, so d's slots are one run; only the run's
      // first slot with source s stores, the f32 sum of all of them
      bool first = true;
      for (int k = e - 1; k >= 0 && dst_rel[w + k] == d; --k) {
        if (src_rel[w + k] == s) {
          first = false;
          break;
        }
      }
      if (!first) continue;
      float acc = coeff[w + e];
      for (int k = e + 1; k < EB && dst_rel[w + k] == d; ++k) {
        if (src_rel[w + k] == s) acc += coeff[w + k];
      }
      out[static_cast<long long>(d) * SW + s] = Elem<T>::from_f(acc);
    }
  }
}

constexpr int kApplyWarps = 8;  // Â rows a CTA, one a warp
constexpr int kApplyThreads = 32 * kApplyWarps;
constexpr int kRowInFlight = 1024;  // columns of a row loaded before any is used
constexpr unsigned kFull = 0xffffffffu;

// K2: one warp per Â row r of a tile (t, sample b). The warp streams the
// row with 16-byte evict-first loads, kInFlight chunks of 32 kVec columns at
// a time, and compacts each chunk's non-zeros in ascending column order
// into a list in shared memory (a warp scan of the lanes' counts); each
// lane then keeps FPL output features and adds a * z[s0 + s, f] for the
// list's entries in order, gathering the z rows U at a time so that their
// loads overlap. A lane's features are f0 + lane + 32 i, except in bf16
// with FPL >= 2, where they come in pairs, f0 + 2 lane + 64 i + {0, 1},
// one 4-byte load each (scalar loads when F is odd). Every output is one fmaf chain in
// ascending column order, as a dense sweep's: a zero entry would add
// a * z = +-0 and change nothing (for finite z), so skipping it keeps the
// dense result bit for bit. The row is read once for all of F up to 32 FPL
// features; wider F takes one pass a chunk of 32 FPL features. Dead tiles
// (t >= live[b]) write zeros without reading the block; source rows at or
// past n_max read as zero.
template <typename T>
struct ApplyParams {
  const T* z;        // (B, n_max, F)
  const T* blocks;   // (B, T, NT, SW)
  const int* s0;     // (B, T) source-window starts
  const int* live;   // (B,) live tiles
  T* out;            // (B, n_max, F)
  int tiles, NT, SW, n_max, F;
  bool vec;          // SW a multiple of kVec and the blocks 16-byte aligned
  bool pairs;        // bf16: F even and z, out 4-byte aligned
};

// the P features of a z row starting at f (f < F checked here): one, or a
// bf16 pair
template <typename T, int P>
__device__ __forceinline__ void load_z(const T* zrow, int f, int F, bool in, bool pairs,
                                       float* v) {
  if constexpr (P == 1) {
    v[0] = in && f < F ? Elem<T>::to_f(__ldg(zrow + f)) : 0.f;
  } else {
    if (pairs) {
      float2 x = make_float2(0.f, 0.f);
      if (in && f < F) x = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(zrow + f)));
      v[0] = x.x;
      v[1] = x.y;
    } else {
      v[0] = in && f < F ? __bfloat162float(__ldg(zrow + f)) : 0.f;
      v[1] = in && f + 1 < F ? __bfloat162float(__ldg(zrow + f + 1)) : 0.f;
    }
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_out(T* orow, int f, int F, bool pairs, const float* v) {
  if constexpr (P == 1) {
    if (f < F) orow[f] = Elem<T>::from_f(v[0]);
  } else {
    if (pairs) {
      if (f < F) *reinterpret_cast<__nv_bfloat162*>(orow + f) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
      if (f < F) orow[f] = __float2bfloat16_rn(v[0]);
      if (f + 1 < F) orow[f + 1] = __float2bfloat16_rn(v[1]);
    }
  }
}

template <typename T, int FPL>
__global__ void __launch_bounds__(kApplyThreads) apply_kernel(ApplyParams<T> p) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  constexpr int P = sizeof(T) == 2 && FPL >= 2 ? 2 : 1;  // features a lane loads at once
  constexpr int kChunk = 32 * V;  // columns of a row a warp reads at once
  constexpr int kInFlight = kRowInFlight / kChunk;
  const int T_ = p.tiles, NT = p.NT, SW = p.SW, n_max = p.n_max, F = p.F;
  constexpr int U = FPL <= 4 ? 8 : 4;  // z rows gathered together
  __shared__ int list_s[kApplyWarps][kChunk];
  __shared__ float list_a[kApplyWarps][kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kApplyWarps + warp;
  const int t = blockIdx.y, b = blockIdx.z;
  const int gr = t * NT + r;
  if (r >= NT || gr >= n_max) return;  // uniform across the warp; no block barrier
  T* orow = p.out + (static_cast<long long>(b) * n_max + gr) * F;
  if (t >= p.live[b]) {
    for (int f = lane; f < F; f += 32) orow[f] = E::from_f(0.f);
    return;
  }
  const T* arow = p.blocks + ((static_cast<long long>(b) * T_ + t) * NT + r) * SW;
  const T* Z = p.z + static_cast<long long>(b) * n_max * F;
  const int start = p.s0[b * T_ + t];
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
          const T* zrow = Z + static_cast<long long>(zr) * F;
#pragma unroll
          for (int i = 0; i < FPL; i += P) {
            load_z<T, P>(zrow, f0 + P * lane + 32 * i, F, in, p.pairs, &zv[u][i]);
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
      float a[kInFlight][V];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int col = c0 + j * kChunk + V * lane;
        if (p.vec) {
          if (col < SW) {
            E::load_vec(arow + col, a[j]);
          } else {
#pragma unroll
            for (int c = 0; c < V; ++c) a[j][c] = 0.f;
          }
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) a[j][c] = col + c < SW ? E::to_f(arow[col + c]) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int cb = c0 + j * kChunk;
        if (cb >= SW) break;  // uniform across the warp
        int cnt = 0;
#pragma unroll
        for (int c = 0; c < V; ++c) cnt += a[j][c] != 0.f;
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
        for (int c = 0; c < V; ++c) {
          if (a[j][c] != 0.f) {
            ls[pos] = cb + V * lane + c;
            la[pos] = a[j][c];
            ++pos;
          }
        }
        n += total;
      }
    }
    flush();
#pragma unroll
    for (int i = 0; i < FPL; i += P) {
      store_out<T, P>(orow, f0 + P * lane + 32 * i, F, p.pairs, &acc[i]);
    }
  }
}

template <typename T, int FPL>
cudaError_t launch_apply(const ApplyParams<T>& p, int B, cudaStream_t stream) {
  const dim3 grid((p.NT + kApplyWarps - 1) / kApplyWarps, p.tiles, B);
  apply_kernel<T, FPL><<<grid, kApplyThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, unsigned bytes) {
  return reinterpret_cast<std::uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
int build_blocks(const int* src_rel, const int* dst_rel, const float* coeff, const int* live,
                 T* blocks, int B, int T_, int EB, int NT, int SW, void* stream) {
  if (!aligned(blocks, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid(T_, B);
  build_blocks_kernel<T><<<grid, kBuildThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src_rel, dst_rel, coeff, live, blocks, T_, EB, NT, SW);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply(const T* z, const T* blocks, const int* s0, const int* live, T* out, int B, int T_,
          int NT, int SW, int n_max, int F, int fpl, void* stream) {
  if (B < 0 || B > 65535 || T_ < 0 || T_ > 65535 || NT < 1 || SW < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T_ == 0) return 0;
  constexpr int V = Elem<T>::kVec;
  const bool vec = SW % V == 0 && aligned(blocks, 16);
  const bool pairs = F % 2 == 0 && aligned(z, 4) && aligned(out, 4);
  const ApplyParams<T> p{z, blocks, s0, live, out, T_, NT, SW, n_max, F, vec, pairs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fpl) {
    case 1: return static_cast<int>(launch_apply<T, 1>(p, B, s));
    case 2: return static_cast<int>(launch_apply<T, 2>(p, B, s));
    case 4: return static_cast<int>(launch_apply<T, 4>(p, B, s));
    case 8: return static_cast<int>(launch_apply<T, 8>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int qtm_spmm_build_blocks(const int* src_rel, const int* dst_rel, const float* coeff,
                                     const int* live, float* blocks, int B, int T, int EB,
                                     int NT, int SW, void* stream) {
  return build_blocks<float>(src_rel, dst_rel, coeff, live, blocks, B, T, EB, NT, SW, stream);
}

extern "C" int qtm_spmm_build_blocks_bf16(const int* src_rel, const int* dst_rel,
                                          const float* coeff, const int* live, void* blocks,
                                          int B, int T, int EB, int NT, int SW, void* stream) {
  return build_blocks<bf16>(src_rel, dst_rel, coeff, live, static_cast<bf16*>(blocks), B, T, EB,
                            NT, SW, stream);
}

// fpl: output features a lane (1, 2, 4 or 8); F wider than 32 fpl takes one
// pass over the row a chunk of 32 fpl features.
extern "C" int qtm_spmm_apply(const float* z, const float* blocks, const int* s0,
                              const int* live, float* out, int B, int T, int NT, int SW,
                              int n_max, int F, int fpl, void* stream) {
  return apply<float>(z, blocks, s0, live, out, B, T, NT, SW, n_max, F, fpl, stream);
}

extern "C" int qtm_spmm_apply_bf16(const void* z, const void* blocks, const int* s0,
                                   const int* live, void* out, int B, int T, int NT, int SW,
                                   int n_max, int F, int fpl, void* stream) {
  return apply<bf16>(static_cast<const bf16*>(z), static_cast<const bf16*>(blocks), s0, live,
                     static_cast<bf16*>(out), B, T, NT, SW, n_max, F, fpl, stream);
}
