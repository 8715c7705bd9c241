// The row-a-warp K2 (Â·z over per-tile dense Â blocks), kept beside the
// staged kernel of spmm.cu as its yardstick: chip_smoke.py and
// chip_ab.py time the two on the same operands and hold the staged kernel
// to this one bit for bit. No path of the port launches it
// (ops/spmm.py _apply_rowwarp_cuda counts no launch).
//
// One warp takes one Â row r of a tile (t, sample b), 8 warps a CTA, and
// streams its 1024 columns as 16-byte evict-first loads before using any:
// 4 KiB in flight a warp in f32, 2 KiB in bf16, so the bf16 kernel reads
// half the bytes at about the f32 kernel's time. Each chunk of 32 16-byte
// vectors is compacted in ascending column order into a list in shared
// memory, and each lane keeps FPL output features, adding a * z[s0 + s, f]
// for the list's entries in order: every output is one f32 fmaf chain in
// ascending column order, rounded once on the store in bf16. Wider F than
// 32 FPL re-reads and re-compacts the row once a pass. On a shared mesh
// (metadata batch 1) every sample's warps read the same row: the blocks
// are streamed once a sample. Dead tiles (t >= live[b]) write zeros; source
// rows at or past n_max read as zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  const T* blocks;   // (M, T, NT, SW), M = B or 1 (a shared mesh)
  const int* s0;     // (M, T) source-window starts
  const int* live;   // (M,) live tiles
  T* out;            // (B, n_max, F)
  int tiles, NT, SW, n_max, F;
  int mstride;       // 1: a mesh a sample; 0: one mesh for the batch
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
  const int mb = b * p.mstride;  // the sample's mesh
  const int gr = t * NT + r;
  if (r >= NT || gr >= n_max) return;  // uniform across the warp; no block barrier
  T* orow = p.out + (static_cast<long long>(b) * n_max + gr) * F;
  if (t >= p.live[mb]) {
    for (int f = lane; f < F; f += 32) orow[f] = E::from_f(0.f);
    return;
  }
  const T* arow = p.blocks + ((static_cast<long long>(mb) * T_ + t) * NT + r) * SW;
  const T* Z = p.z + static_cast<long long>(b) * n_max * F;
  const int start = p.s0[mb * T_ + t];
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
int apply(const T* z, const T* blocks, const int* s0, const int* live, T* out, int B,
          int meta_b, int T_, int NT, int SW, int n_max, int F, int fpl, void* stream) {
  if (B < 0 || B > 65535 || T_ < 0 || T_ > 65535 || NT < 1 || SW < 1 || F < 1 ||
      (meta_b != B && meta_b != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T_ == 0) return 0;
  constexpr int V = Elem<T>::kVec;
  const bool vec = SW % V == 0 && aligned(blocks, 16);
  const bool pairs = F % 2 == 0 && aligned(z, 4) && aligned(out, 4);
  const int mstride = meta_b == B ? 1 : 0;
  const ApplyParams<T> p{z, blocks, s0, live, out, T_, NT, SW, n_max, F, mstride, vec, pairs};
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

// fpl: output features a lane (1, 2, 4 or 8; F wider than 32 fpl takes one
// pass over the row a chunk of 32 fpl features). meta_b: the batch axis of
// blocks, s0 and live, B (a mesh a sample) or 1 (one mesh for the batch).
extern "C" int qtm_spmm_apply_rowwarp(const float* z, const float* blocks, const int* s0,
                                      const int* live, float* out, int B, int meta_b, int T,
                                      int NT, int SW, int n_max, int F, int fpl, void* stream) {
  return apply<float>(z, blocks, s0, live, out, B, meta_b, T, NT, SW, n_max, F, fpl, stream);
}

extern "C" int qtm_spmm_apply_rowwarp_bf16(const void* z, const void* blocks, const int* s0,
                                           const int* live, void* out, int B, int meta_b, int T,
                                           int NT, int SW, int n_max, int F, int fpl,
                                           void* stream) {
  return apply<bf16>(static_cast<const bf16*>(z), static_cast<const bf16*>(blocks), s0, live,
                     static_cast<bf16*>(out), B, meta_b, T, NT, SW, n_max, F, fpl, stream);
}
