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
// _apply_kernel), and K2b launches it on the cotangent (Â is symmetric):
// out[b, t*NT + r, f] = sum_s blocks[m, t, r, s] * z[b, s0[m, t] + s, f],
// accumulated in f32 with no TF32, as the TPU kernel runs f32 at
// Precision.HIGHEST; m = b on a mesh a sample, m = 0 on a shared mesh
// (TrainConfig.shared_mesh: blocks, s0 and live of batch 1). The TPU
// densifies Â so that its MXU can take the product; here an Â row holds a
// handful of non-zeros among SW = 1024 columns, so the kernel streams the
// blocks (the bytes that bound it) and does only the non-zeros' FMAs.
//
// One CTA of 8 warps takes a unit: a slab of R rows of a tile, with every
// output column those rows feed: the F features of its sample on a mesh
// a sample, and on a shared mesh all B*F columns of the batch folded into
// the features (column j is sample j / F, feature j mod F, as the JAX
// package folds the batch), z and out addressed in place through their
// batch stride. So each Â row is read once a call, whatever the width,
// the type or the batch's mesh sharing. The CTA
//  1. stages its R rows in shared memory with one bulk asynchronous copy
//     (cp.async.bulk, completing on an mbarrier): the bytes in flight are
//     a CTA's (R*SW*size, at most 32 KiB), not a warp's registers;
//  2. compacts each row once (a warp a row), in ascending column order,
//     into (column, value) entries in its share of a pool of 512 entries
//     (64 a row at R = 8; a warp scan a chunk of 32 16-byte vectors, the
//     chunks without a non-zero skipped by a ballot);
//  3. walks the lists for every output column: a thread takes one row's
//     VZ consecutive columns (one load of z of up to 16 bytes a list
//     entry, 8 entries' loads in flight), a row's columns on consecutive
//     threads, so narrow widths fill a warp with rows and no lane idles.
//     Each output is one fmaf chain over the row's non-zeros in ascending
//     column order, as a dense sweep's: a zero entry would add a * z = +-0
//     and change nothing (for finite z), so skipping it keeps the dense
//     result bit for bit. bf16 values are widened exactly and each output
//     rounded once on the store.
// R is at most 8 rows (a warp a row in step 2) and no more rows than the
// 256 threads walk at once in step 3, so a unit's latency is one copy, one
// pass over the staged rows, one barrier and one walk; at the main path's
// widths that is 8 rows, and on a shared mesh at batch 16-32 1 to 4 rows
// of 256-4096 columns.
// A row whose list does not fit its share is walked from its staged copy
// instead, in the same order (slower: a quadtree node of the configured
// meshes, max_grid_size 8, has at most 36 neighbours). Where a row's outputs take 512 bytes or more (f32 at F 128, a
// shared mesh's fold), z and out are large next to the blocks, and the bulk
// copy asks the L2 to give the blocks' lines up first, as they are read
// once, so that the gathered z rows stay; at narrow widths it does not, so
// that a mesh's blocks stay for the next Â·z of the step. Rows whose
// bytes are not whole 16-byte vectors are staged by the threads instead
// of the bulk copy. Dead tiles (t >= live) write zeros without reading
// their block; source rows at or past n_max read as zero, so z is not
// padded. Bound: the bytes of the live tiles' blocks, and at wide folded
// widths the outputs'.
//
// Both kernels take a leading batch axis, one mesh per sample, so one
// launch serves a whole batch; K1 builds a shared mesh's blocks once
// (batch 1). They launch on the caller's stream, do not synchronise and
// allocate nothing; each entry point returns cudaGetLastError() so that
// the Python wrapper raises on a refused launch.

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
  static __device__ __forceinline__ void unpack(const uint4& a, float (&v)[4]) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
};

template <>
struct Elem<bf16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ bf16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ void unpack(const uint4& a, float (&v)[8]) {
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

constexpr int kApplyThreads = 256;  // 8 warps a CTA
constexpr int kApplyWarps = kApplyThreads / 32;
constexpr int kMaxRows = 32;  // rows a CTA
constexpr int kPool = 512;    // list entries a CTA
constexpr unsigned kFull = 0xffffffffu;
// K2's dynamic shared memory: the mbarrier, the rows' counts and list
// offsets, the pool's columns and values, then the staged rows (128-byte
// aligned). ops/spmm.py apply_plan computes the same layout.
constexpr int kCountsAt = 16;
constexpr int kColsAt = kCountsAt + 2 * 4 * kMaxRows;
constexpr int kValsAt = kColsAt + 4 * kPool;
constexpr int kStageAt = (kValsAt + 4 * kPool + 127) / 128 * 128;
constexpr int kMaxSmem = 227 * 1024;  // a CTA's shared memory on sm_90

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one thread: arrive on bar expecting `bytes`, and copy them from global to
// shared memory, completing on bar (both 16-byte aligned, bytes % 16 == 0);
// with evict_first the L2 gives the copied lines up before others
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar, bool evict_first) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (evict_first) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

template <int Bytes>
struct RawOf;
template <>
struct RawOf<2> {
  using type = unsigned short;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<16> {
  using type = uint4;
};

// VZ consecutive values of T, moved as one load or store
template <typename T, int VZ>
struct Pack {
  using Raw = typename RawOf<static_cast<int>(VZ * sizeof(T))>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) { raw = __ldg(reinterpret_cast<const Raw*>(p)); }
  __device__ __forceinline__ float get(int i) const {
    return Elem<T>::to_f(reinterpret_cast<const T*>(&raw)[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[VZ]) {
    alignas(16) T e[VZ];
#pragma unroll
    for (int i = 0; i < VZ; ++i) e[i] = Elem<T>::from_f(v[i]);
    *reinterpret_cast<Raw*>(p) = *reinterpret_cast<const Raw*>(e);
  }
};

template <typename T>
struct ApplyParams {
  const T* z;       // (B, n_max, F)
  const T* blocks;  // (M, T, NT, SW), M = B or 1 (a shared mesh)
  const int* s0;    // (M, T) source-window starts
  const int* live;  // (M,) live tiles
  T* out;           // (B, n_max, F)
  int tiles, NT, SW, n_max, F;
  int mstride;  // 1: a mesh a sample (grid z: the sample); 0: one mesh for the batch
  int fold;     // samples in a unit's columns: B on a shared mesh, else 1
  int rows;     // R, the Â rows of a unit
  int stride;   // a staged row's length: SW rounded up to whole 16-byte vectors
  bool bulk;    // one bulk copy stages the rows (stride == SW, blocks 16-byte aligned)
  bool wide;    // a row's outputs take 512 bytes or more: the blocks' lines go first
};

// One CTA a unit: rows [R x, R x + R) of tile y, for sample z (a mesh a
// sample) or for the whole batch (a shared mesh, grid z = 1).
template <typename T, int VZ>
__global__ void __launch_bounds__(kApplyThreads) apply_kernel(const ApplyParams<T> p) {
  using E = Elem<T>;
  using P = Pack<T, VZ>;
  constexpr int V = E::kVec;
  // z loads in flight a thread: 4 at 16-byte bf16 vectors, whose widening
  // costs registers, else 8
  constexpr int kGather = sizeof(T) == 2 && VZ == 8 ? 4 : 8;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* cnt = reinterpret_cast<int*>(smem + kCountsAt);  // a row's non-zeros
  int* off = cnt + kMaxRows;  // a row's first pool entry; -1: its list does not fit
  int* lcol = reinterpret_cast<int*>(smem + kColsAt);
  float* lval = reinterpret_cast<float*>(smem + kValsAt);
  T* stage = reinterpret_cast<T*>(smem + kStageAt);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int NT = p.NT, SW = p.SW, n_max = p.n_max, F = p.F, W = p.fold * F;
  const int t = blockIdx.y, mb = blockIdx.z * p.mstride, b0 = blockIdx.z * p.fold;
  const int r0 = blockIdx.x * p.rows, g0 = t * NT + r0;
  const int nr = min(p.rows, min(NT - r0, n_max - g0));  // rows with outputs
  if (nr <= 0) return;  // uniform across the CTA, as every branch below
  const long long bs = static_cast<long long>(n_max) * F;  // batch stride of z and out
  T* const out = p.out + b0 * bs + static_cast<long long>(g0) * F;
  const int start = p.s0[mb * p.tiles + t];  // loaded beside live, used in step 3
  if (t >= p.live[mb]) {  // a dead tile: zeros, its block unread
    const int per = nr * F / VZ;  // vectors a sample
    for (int i = tid; i < p.fold * per; i += kApplyThreads) {
      const int s = i / per;
      *reinterpret_cast<typename P::Raw*>(out + s * bs + static_cast<long long>(i - s * per) * VZ) =
          typename P::Raw{};
    }
    return;
  }

  // 1. stage the unit's rows
  const int stride = p.stride;
  const long long row0 = (static_cast<long long>(mb) * p.tiles + t) * NT + r0;
  const T* src = p.blocks + row0 * SW;
  if (p.bulk) {
    if (tid == 0) {
      mbar_init(bar, 1);
      bulk_load(stage, src, static_cast<unsigned>(nr * SW * sizeof(T)), bar, p.wide);
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    mbar_wait(bar, 0);
  } else {
    for (int i = tid; i < nr * stride; i += kApplyThreads) {
      const int r = i / stride, c = i - r * stride;
      stage[i] = c < SW ? src[static_cast<long long>(r) * SW + c] : E::from_f(0.f);
    }
    __syncthreads();
  }

  // 2. compact each row once (a warp a row) into its share of the pool
  const int nvec = stride / V;
  const int seg = kPool / nr;  // a row's share of the pool
  for (int r = warp; r < nr; r += kApplyWarps) {
    const uint4* row = reinterpret_cast<const uint4*>(stage + r * stride);
    int n = 0;
    bool over = false;
    for (int v0 = 0; v0 < nvec; v0 += 32) {
      const int v = v0 + lane;
      float a[V];
      if (v < nvec) {
        E::unpack(row[v], a);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = 0.f;
      }
      int c = 0;
#pragma unroll
      for (int i = 0; i < V; ++i) c += a[i] != 0.f;
      if (__ballot_sync(kFull, c != 0) == 0) continue;
      const int inc = warp_inclusive_scan(c, lane);
      const int total = __shfl_sync(kFull, inc, 31);
      if (n + total > seg) {  // walked from its staged copy below
        over = true;
        break;
      }
      int pos = r * seg + n + inc - c;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (a[i] != 0.f) {
          lcol[pos] = v * V + i;
          lval[pos] = a[i];
          ++pos;
        }
      }
      n += total;
    }
    if (lane == 0) {
      cnt[r] = n;
      off[r] = over ? -1 : r * seg;
    }
  }
  __syncthreads();

  // 3. walk the lists: a thread a (row, VZ consecutive columns), the
  // columns of a row on consecutive threads
  const int per_row = W / VZ;  // vectors of a row
  for (int it = tid; it < nr * per_row; it += kApplyThreads) {
    const int r = it / per_row;
    const int j = (it - r * per_row) * VZ;  // the thread's first column
    const int s = j / F, f = j - s * F;
    const T* zc = p.z + (b0 + s) * bs + f;
    float acc[VZ];
#pragma unroll
    for (int i = 0; i < VZ; ++i) acc[i] = 0.f;
    const int o = off[r];
    if (o >= 0) {
      const int e = o + cnt[r];
      for (int k0 = o; k0 < e; k0 += kGather) {
        P zv[kGather];
        float av[kGather];
#pragma unroll
        for (int q = 0; q < kGather; ++q) {
          const bool ok = k0 + q < e;
          av[q] = ok ? lval[k0 + q] : 0.f;
          const int zr = start + (ok ? lcol[k0 + q] : 0);
          zv[q].raw = typename P::Raw{};
          if (ok && zr < n_max) zv[q].load(zc + static_cast<long long>(zr) * F);
        }
#pragma unroll
        for (int q = 0; q < kGather; ++q) {
          if (k0 + q < e) {
#pragma unroll
            for (int i = 0; i < VZ; ++i) acc[i] = fmaf(av[q], zv[q].get(i), acc[i]);
          }
        }
      }
    } else {
      const T* row = stage + r * stride;
      for (int c = 0; c < SW; ++c) {
        const float a = E::to_f(row[c]);
        if (a == 0.f) continue;
        const int zr = start + c;
        P zv;
        zv.raw = typename P::Raw{};
        if (zr < n_max) zv.load(zc + static_cast<long long>(zr) * F);
#pragma unroll
        for (int i = 0; i < VZ; ++i) acc[i] = fmaf(a, zv.get(i), acc[i]);
      }
    }
    P::store(out + s * bs + static_cast<long long>(r) * F + f, acc);
  }
}

template <typename T, int VZ>
cudaError_t launch_apply(const ApplyParams<T>& p, dim3 grid, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        apply_kernel<T, VZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  apply_kernel<T, VZ><<<grid, kApplyThreads, smem, stream>>>(p);
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
int apply(const T* z, const T* blocks, const int* s0, const int* live, T* out, int B,
          int meta_b, int T_, int NT, int SW, int n_max, int F, int rows, int vz, void* stream) {
  const unsigned vbytes = static_cast<unsigned>(vz) * sizeof(T);
  if (B < 0 || B > 65535 || T_ < 0 || T_ > 65535 || NT < 1 || SW < 1 || F < 1 ||
      (meta_b != B && meta_b != 1) || rows < 1 || rows > kMaxRows ||
      (vz != 1 && vz != 2 && vz != 4 && vz != 8) || vbytes > 16 || F % vz != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T_ == 0) return 0;
  if (!aligned(z, vbytes) || !aligned(out, vbytes))
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int V = Elem<T>::kVec;
  const int stride = (SW + V - 1) / V * V;
  const long long smem = kStageAt + static_cast<long long>(rows) * stride * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int fold = B / meta_b;  // B meshes of a sample, or one mesh of B
  const bool bulk = stride == SW && aligned(blocks, 16);
  const bool wide = static_cast<long long>(fold) * F * sizeof(T) >= 512;
  const ApplyParams<T> p{z, blocks, s0, live, out, T_, NT, SW, n_max, F,
                         meta_b == B ? 1 : 0, fold, rows, stride, bulk, wide};
  const dim3 grid((NT + rows - 1) / rows, T_, meta_b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(smem);
  switch (vz) {
    case 1: return static_cast<int>(launch_apply<T, 1>(p, grid, bytes, s));
    case 2: return static_cast<int>(launch_apply<T, 2>(p, grid, bytes, s));
    case 4: return static_cast<int>(launch_apply<T, 4>(p, grid, bytes, s));
    default:
      if constexpr (sizeof(T) == 2) return static_cast<int>(launch_apply<T, 8>(p, grid, bytes, s));
      return static_cast<int>(cudaErrorInvalidValue);
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

// The plan (ops/spmm.py apply_plan): rows, the Â rows a CTA stages (1 to
// 32); vz, the consecutive output columns a thread keeps (1, 2, 4 or 8, F
// % vz == 0, vz * the element size at most 16 bytes, z and out aligned to
// it). meta_b: the batch axis of blocks, s0 and live, B (a mesh a sample)
// or 1 (one mesh for the batch, whose B*F columns one CTA computes).
extern "C" int qtm_spmm_apply(const float* z, const float* blocks, const int* s0,
                              const int* live, float* out, int B, int meta_b, int T, int NT,
                              int SW, int n_max, int F, int rows, int vz, void* stream) {
  return apply<float>(z, blocks, s0, live, out, B, meta_b, T, NT, SW, n_max, F, rows, vz, stream);
}

extern "C" int qtm_spmm_apply_bf16(const void* z, const void* blocks, const int* s0,
                                   const int* live, void* out, int B, int meta_b, int T, int NT,
                                   int SW, int n_max, int F, int rows, int vz, void* stream) {
  return apply<bf16>(static_cast<const bf16*>(z), static_cast<const bf16*>(blocks), s0, live,
                     static_cast<bf16*>(out), B, meta_b, T, NT, SW, n_max, F, rows, vz, stream);
}
