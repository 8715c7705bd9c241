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
// The kernel takes a leading batch axis (one mesh per sample) through the
// offsets, launches on the caller's stream, does not synchronise and
// allocates nothing; the entry point returns cudaGetLastError() so that the
// Python wrapper raises on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 8;  // features a lane accumulates per pass over a row

template <int LPR>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ values, const int* __restrict__ order,
                   const int* __restrict__ offsets, float* __restrict__ out,
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
  float* dst = out + row * F;

  for (int f0 = 0; f0 < F; f0 += LPR * kPerLane) {
    float acc[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
    for (int j = start; j < end; ++j) {
      const long long e = order != nullptr ? order[j] : j;
      const float* src = values + e * F;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int f = f0 + sub + i * LPR;
        if (f < F) acc[i] = __fadd_rn(acc[i], src[f]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int f = f0 + sub + i * LPR;
      if (f < F) dst[f] = acc[i];
    }
  }
}

template <int LPR>
void launch(const float* values, const int* order, const int* offsets, float* out,
            long long rows, int n_out, int F, cudaStream_t stream) {
  const long long threads = rows * LPR;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  segment_sum_kernel<LPR><<<blocks, kThreads, 0, stream>>>(values, order, offsets, out, rows,
                                                          n_out, F);
}

}  // namespace

extern "C" {

// values (B*L, F) f32; order (B*L) int32 global entry indices, or null when
// the entries are already in bucket order; offsets (B, n_out + 1) int32
// global entry positions; out (B*n_out, F) f32.
int qtm_segment_sum(const float* values, const int* order, const int* offsets, float* out,
                    int batch, int n_out, int F, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n_out;
  if (rows > 0 && F > 0) {
    if (F >= 32) {
      launch<32>(values, order, offsets, out, rows, n_out, F, stream);
    } else if (F > 8) {
      launch<16>(values, order, offsets, out, rows, n_out, F, stream);
    } else if (F > 4) {
      launch<8>(values, order, offsets, out, rows, n_out, F, stream);
    } else if (F > 2) {
      launch<4>(values, order, offsets, out, rows, n_out, F, stream);
    } else if (F == 2) {
      launch<2>(values, order, offsets, out, rows, n_out, F, stream);
    } else {
      launch<1>(values, order, offsets, out, rows, n_out, F, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
