// Segment sum on Hopper (sm_90a): kernel K7.
//
// K7 qtm_segment_sum replaces segment_sum_pallas / _kernel of
// quadtree_mpnnlstm_tpu/ops/pallas_segment.py:
//
//   out[b, n, f] = sum over entries e of sample b with ids[b, e] == n of values[b, e, f]
//
// with ids outside [0, n_out) dropped. The TPU kernel builds a one-hot
// (tile_e x n_out) tile in VMEM, multiplies it on the MXU and carries the
// (n_out, F) output resident across a sequential grid; none of that carries
// over to a card whose blocks run in parallel and in no order. Here the
// owner of an output row computes it, with no float atomics: the wrapper
// (ops/segment_sum.py segment_view) turns the ids into a CSR view once per
// id vector, a stable order of the entries by bucket (none for ids that are
// already sorted) and per-sample bucket offsets, and the kernel gives each
// output row LPR lanes (LPR = F rounded up to a power of two, at most 32;
// so at F = 1 a warp owns 32 rows and no lane idles). The lanes of a row
// split its features and walk the row's entries in ascending entry order,
// adding with __fadd_rn (no contraction can reorder the sum): the result
// is bit for bit the sequential, entry-ordered sum that
// index_put_(accumulate=True) takes. Dropped entries lie in no row's range,
// so no scratch rows are written. Empty rows get 0.
//
// Bound: bytes. Each valid entry's F values are read once and each output
// row written once (one add per value read, far below the f32 rate); the
// view adds 4-8 bytes an entry. Rows of different degree share a warp only
// at F < 32, where the pixelwise mesh's degrees differ by at most 4.
//
// The bf16 path (qtm_segment_sum_bf16, the TPU kernel on bf16 values) reads
// bf16 values, adds them in f32 in the same entry order and rounds each
// output once on the store, where the TPU kernel rounds the output at every
// 512-entry tile. Where F is a multiple of 8 (and the values 16-byte
// aligned) a lane reads 8 features of an entry as one 16-byte load and a row
// takes F/8 lanes (rounded up to a power of two, at most 32); else the lanes
// split the features as in f32.
//
// The kernel takes a leading batch axis (one mesh per sample) through the
// offsets, launches on the caller's stream, does not synchronise and
// allocates nothing; the entry point returns cudaGetLastError() so that the
// Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPerLane = 8;  // features a lane accumulates per pass over a row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// VEC (bf16 only): a lane's kPerLane features are contiguous, one 16-byte
// load an entry; else they are strided by LPR.
template <typename T, int LPR, bool VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ order,
                   const int* __restrict__ offsets, T* __restrict__ out,
                   long long rows, int n_out, int F) {
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = thread / LPR;
  const int sub = static_cast<int>(thread % LPR);
  if (row >= rows) return;
  const long long b = row / n_out;
  const long long n = row - b * n_out;
  const int* off = offsets + b * (n_out + 1) + n;
  const int start = off[0];
  const int end = off[1];
  T* dst = out + row * F;

  for (int f0 = 0; f0 < F; f0 += LPR * kPerLane) {
    float acc[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
    if constexpr (VEC) {
      const int f = f0 + sub * kPerLane;
      if (f >= F) continue;
      for (int j = start; j < end; ++j) {
        const long long e = order != nullptr ? order[j] : j;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(values + e * F + f));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < kPerLane / 2; ++i) {
          const float2 x = __bfloat1622float2(h[i]);
          acc[2 * i] = __fadd_rn(acc[2 * i], x.x);
          acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], x.y);
        }
      }
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < kPerLane / 2; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      *reinterpret_cast<uint4*>(dst + f) = packed;
    } else {
      for (int j = start; j < end; ++j) {
        const long long e = order != nullptr ? order[j] : j;
        const T* src = values + e * F;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int f = f0 + sub + i * LPR;
          if (f < F) acc[i] = __fadd_rn(acc[i], to_f(src[f]));
        }
      }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int f = f0 + sub + i * LPR;
        if (f < F) dst[f] = from_f<T>(acc[i]);
      }
    }
  }
}

template <typename T, int LPR, bool VEC>
void launch(const T* values, const int* order, const int* offsets, T* out, long long rows,
            int n_out, int F, cudaStream_t stream) {
  const long long threads = rows * LPR;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  segment_sum_kernel<T, LPR, VEC><<<blocks, kThreads, 0, stream>>>(values, order, offsets, out,
                                                                  rows, n_out, F);
}

// lanes a row: F (or, with VEC, F / 8 vectors) rounded up to a power of two,
// at most 32
template <typename T, bool VEC>
void dispatch(const T* values, const int* order, const int* offsets, T* out, long long rows,
              int n_out, int F, cudaStream_t stream) {
  const int width = VEC ? F / kPerLane : F;
  if (width >= 32) {
    launch<T, 32, VEC>(values, order, offsets, out, rows, n_out, F, stream);
  } else if (width > 8) {
    launch<T, 16, VEC>(values, order, offsets, out, rows, n_out, F, stream);
  } else if (width > 4) {
    launch<T, 8, VEC>(values, order, offsets, out, rows, n_out, F, stream);
  } else if (width > 2) {
    launch<T, 4, VEC>(values, order, offsets, out, rows, n_out, F, stream);
  } else if (width == 2) {
    launch<T, 2, VEC>(values, order, offsets, out, rows, n_out, F, stream);
  } else {
    launch<T, 1, VEC>(values, order, offsets, out, rows, n_out, F, stream);
  }
}

}  // namespace

extern "C" {

// values (B*L, F) f32; order (B*L) int32 global entry indices, or null when
// the entries are already in bucket order; offsets (B, n_out + 1) int32
// global entry positions; out (B*n_out, F) f32.
int qtm_segment_sum(const float* values, const int* order, const int* offsets, float* out,
                    int batch, int n_out, int F, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n_out;
  if (rows > 0 && F > 0) dispatch<float, false>(values, order, offsets, out, rows, n_out, F, stream);
  return static_cast<int>(cudaGetLastError());
}

// the same with values and out in bf16
int qtm_segment_sum_bf16(const void* values, const int* order, const int* offsets, void* out,
                         int batch, int n_out, int F, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n_out;
  const bf16* v = static_cast<const bf16*>(values);
  bf16* o = static_cast<bf16*>(out);
  const bool vec = F % kPerLane == 0 && reinterpret_cast<std::uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  if (rows > 0 && F > 0) {
    if (vec) {
      dispatch<bf16, true>(v, order, offsets, o, rows, n_out, F, stream);
    } else {
      dispatch<bf16, false>(v, order, offsets, o, rows, n_out, F, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
