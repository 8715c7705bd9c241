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
// already sorted) and per-sample bucket offsets. Every output is the sum of
// its bucket's values in ascending entry order, starting from 0, each add
// an __fadd_rn (no contraction can reorder it): bit for bit the
// sequential, entry-ordered sum that index_put_(accumulate=True) takes on
// the CPU. Dropped entries lie in no row's range. Empty rows get 0. bf16
// values are added in f32 and each output rounded once on the store, where
// the TPU kernel rounds the output at every 512-entry tile.
//
// Bound: bytes. Each valid entry's F values are read once and each output
// row written once (one add per value read); the view adds 4-8 bytes an
// entry. On the quadtree paths the bound is a microsecond or less, so what
// a launch pays is latency: the dependent round trips to memory on its
// longest path, and how evenly its work is spread over the card.
//
// Two layouts; the plan (ops/segment_sum.py segment_plan, a pure Python
// function the CPU tests replay) picks one from F, the dtype, the view's
// kind and the shapes, never from the data:
//
// * spans: F <= 16 over an unsorted view of at most 8192 rows a sample,
//   i.e. a quadtree's pixel->node view (the main path's pooling, node counts
//   and gather cotangents, over a node capacity of 2048 rows). Its compact
//   node ids put a mesh's rows first and its capacity padding after, and a
//   row holds 1-64 pixels: 64 rows of 64 under random weights, or ~1500
//   mostly single pixels and a few leaves of 64 on a detailed frame. The
//   lanes layout below gave each row one or two lanes, which walked it one
//   dependent pair of loads (order[j], then the values) at a time, while
//   most threads only stored zeros. A layout that hands out rows (a warp of
//   32 rows, say) is only as fast as its heaviest group of rows, and where
//   the long rows lie depends on the image. So the work is handed out by
//   entries, as merge-path SpMV does: CTA c of a sample owns the non-empty
//   rows whose entries start in the sample's CSR positions [c * span, (c +
//   1) * span), at most one row's length more than span entries whatever
//   the mesh. A CTA stages the sample's offsets in shared memory in one
//   round of coalesced loads, which also count the rows that start before
//   its span and before its end (its first and one past its last row: a
//   binary search there took longer than the loads). Its rows' entries
//   are one contiguous run of the CSR order: it reads that run of order[]
//   coalesced, then issues every value load of the batch at once over
//   (entry, vector) pairs, up to 16 bytes a load and 8 in flight a thread,
//   and, while they fly, writes zeros over its share of the sample's empty
//   rows with vector stores that nobody waits on; the values are staged in
//   shared memory as f32. Only then does each thread add, for each of its
//   pairs (a row and one feature, or four where the loads are float4-wide:
//   four chains side by side, so a thread holds at most four pairs at F
//   >= 4 however short the rows), the row's staged values in ascending
//   entry order, reading eight entries ahead: an on-chip chain of
//   __fadd_rn carried across batches in registers (a bucket of more than a
//   batch, or rows that share one start, loop in order). The plan picks
//   span so that a span's value loads fit one round of loads and its pairs
//   the threads' registers: three dependent round trips a CTA (offsets,
//   order, values), on any mesh. Two CTAs share an SM (128 registers, the
//   largest shared-memory carveout), so the main path's launches of 64-256
//   CTAs run in one wave.
// * lanes: everything else. A row takes LPR lanes (F, or with 16-byte bf16
//   loads F / 8, rounded up to a power of two, at most 32), which split its
//   features and walk its entries in ascending order. Its rows are short or
//   wide: node degrees (the sorted edge lists and the degree sums: 1-21
//   entries), the pixelwise mesh's rows (68,096 a sample, one a pixel, at
//   most 4 entries; more rows than the spans layout stages), or F > 16,
//   where a row already gives a warp 32 lanes of coalesced loads (84-89 %
//   of the bound at F 32 and 256 on the edge list). On the short ones a
//   launch of this layout runs at 2-3 us on the H100, near the launch
//   floor, so it keeps its first design.
//
// The kernels take a leading batch axis (one mesh per sample) through the
// offsets, launch on the caller's stream, do not synchronise and allocate
// nothing; the entry points return cudaGetLastError(), or
// cudaErrorInvalidValue for a plan they do not take, so that the Python
// wrapper raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------- spans

constexpr int kSpanThreads = 256;  // threads a CTA
constexpr int kSpanPairs = 16;     // (row, feature) sums a thread carries at once
constexpr int kSpanCap = kSpanThreads * kSpanPairs;  // a span's entries times F, at most
constexpr int kSpanLoads = 8;      // value loads a thread keeps in flight
constexpr int kSpanBatch = 1024;   // entries a batch
constexpr int kSpanStage = 8192;   // values a batch stages, as f32
constexpr int kSpanMaxF = 16;      // the layout's widest F
constexpr int kSpanMaxN = 8192;    // rows a sample (their offsets are staged)

// a load of `bytes` bytes
template <int bytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ unsigned word(unsigned short x, int) { return x; }
__device__ __forceinline__ unsigned word(unsigned int x, int) { return x; }
__device__ __forceinline__ unsigned word(uint2 x, int i) { return i == 0 ? x.x : x.y; }
__device__ __forceinline__ unsigned word(uint4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// element c of a load of T values, widened to f32 (a bf16 is the top half
// of its f32, so the shift is __bfloat162float)
template <typename T, typename R>
__device__ __forceinline__ float elem(R x, int c) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word(x, c));
  } else {
    const unsigned w = word(x, c >> 1);
    return __uint_as_float(((c & 1) ? (w >> 16) : (w & 0xffffu)) << 16);
  }
}

// dynamic shared memory: the sample's offsets (padded to 16 bytes), the
// batch's entries and its staged values (with a pad word every 32, see
// stage_index)
__host__ __device__ constexpr int span_offsets_ints(int n_out) { return (n_out + 4) & ~3; }
constexpr int kSpanStageWords = kSpanStage + kSpanStage / 32;
constexpr size_t span_smem_bytes(int n_out) {
  return static_cast<size_t>(span_offsets_ints(n_out) + kSpanBatch + kSpanStageWords) * 4;
}

constexpr unsigned kFull = 0xffffffffu;

// q / d for 0 <= q < 2^24 and 1 <= d <= 16, rd = 1.f / d: a multiply and a
// correction instead of an integer division
__device__ __forceinline__ int div_small(int q, int d, float rd) {
  int k = static_cast<int>((static_cast<float>(q) + 0.5f) * rd);
  if (k * d > q) --k;
  if ((k + 1) * d <= q) ++k;
  return k;
}

// where staged value i lies: with scalar staging (NV < 4) a pad word every
// 32, so that the rows a warp adds in step (at small F, one a lane, 64
// values apart for a mesh's 8 x 8 leaves) fall in different banks; float4
// staging keeps its 16-byte alignment and F >= 4 puts at most eight rows
// in a warp
template <int NV>
__device__ __forceinline__ int stage_index(int i) {
  if constexpr (NV < 4) {
    return i + (i >> 5);
  } else {
    return i;
  }
}

// dst[i] = src[i] (or base + i where src is null) for i in [0, n), by a
// CTA: kSpanLoads loads a thread in flight at a time, so that n <=
// kSpanLoads * kSpanThreads costs one round trip (a loop that stored each
// load before issuing the next would wait for every one of them)
__device__ __forceinline__ void stage_ints(int* dst, const int* src, int base, int n) {
  for (int i0 = 0; i0 < n; i0 += kSpanLoads * kSpanThreads) {
    int v[kSpanLoads];
#pragma unroll
    for (int u = 0; u < kSpanLoads; ++u) {
      const int i = i0 + u * kSpanThreads + static_cast<int>(threadIdx.x);
      if (i < n) v[u] = src != nullptr ? __ldg(src + i) : base + i;
    }
#pragma unroll
    for (int u = 0; u < kSpanLoads; ++u) {
      const int i = i0 + u * kSpanThreads + static_cast<int>(threadIdx.x);
      if (i < n) dst[i] = v[u];
    }
  }
}

// CTA c of sample b (blockIdx.x = b * ctas + c) owns the non-empty rows
// whose entries start in the sample's CSR positions [c * span, (c + 1) *
// span); NV values of T a load (NV | F, values and out aligned to NV *
// sizeof(T)).
template <typename T, int NV>
__global__ void __launch_bounds__(kSpanThreads, 2)
segment_spans_kernel(const T* __restrict__ values, const int* __restrict__ order,
                     const int* __restrict__ offsets, T* __restrict__ out, int ctas, int n_out,
                     int F, int span) {
  using R = typename Raw<NV * static_cast<int>(sizeof(T))>::type;
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_rows[2][kSpanThreads / 32];
  int* const off = smem;
  int* const ent = smem + span_offsets_ints(n_out);
  float* const val = reinterpret_cast<float*>(ent + kSpanBatch);

  const int tid = threadIdx.x;
  const long long b = blockIdx.x / ctas;
  const int c = static_cast<int>(blockIdx.x - b * ctas);
  const int* const off_g = offsets + b * (n_out + 1);
  T* const out_b = out + b * n_out * F;

  // 1. the sample's offsets, staged in one round of loads, which also
  // count the rows that start before this CTA's span and before its end:
  // the first and one past the last row it owns (the offsets ascend)
  const long long x0 = static_cast<long long>(c) * span, x1 = x0 + span;
  const int s0 = __ldg(off_g);
  const int last = tid == 0 ? __ldg(off_g + n_out) : 0;
  int before0 = 0, before1 = 0;
  for (int i0 = 0; i0 < n_out; i0 += kSpanLoads * kSpanThreads) {
    int v[kSpanLoads];
#pragma unroll
    for (int u = 0; u < kSpanLoads; ++u) {
      const int i = i0 + u * kSpanThreads + tid;
      if (i < n_out) v[u] = __ldg(off_g + i);
    }
#pragma unroll
    for (int u = 0; u < kSpanLoads; ++u) {
      const int i = i0 + u * kSpanThreads + tid;
      if (i < n_out) {
        off[i] = v[u];
        before0 += v[u] - s0 < x0;
        before1 += v[u] - s0 < x1;
      }
    }
  }
  if (tid == 0) off[n_out] = last;
  before0 = __reduce_add_sync(kFull, before0);
  before1 = __reduce_add_sync(kFull, before1);
  if ((tid & 31) == 0) {
    s_rows[0][tid >> 5] = before0;
    s_rows[1][tid >> 5] = before1;
  }
  __syncthreads();
  int n_lo = 0, n_hi = 0;
#pragma unroll
  for (int w = 0; w < kSpanThreads / 32; ++w) {
    n_lo += s_rows[0][w];
    n_hi += s_rows[1][w];
  }

  // 2. zeros for the empty rows of this CTA's share of the sample's rows,
  // with stores of NV values that nobody waits on; written while the first
  // batch's value loads are in flight (or at the end, where it owns none)
  const int vpe = F / NV;  // loads (and zero stores) a row
  const float rv = 1.f / static_cast<float>(vpe);
  bool zeroed = false;
  const auto zero_fill = [&]() {
    const int share = (n_out + ctas - 1) / ctas;
    const int r0 = c * share;
    const int units = max(0, min(share, n_out - r0)) * vpe;
    for (int q = tid; q < units; q += kSpanThreads) {
      const int k = div_small(q, vpe, rv);
      const int n = r0 + k;
      if (off[n + 1] == off[n]) {
        *reinterpret_cast<R*>(out_b + static_cast<long long>(n) * F + (q - k * vpe) * NV) = R{};
      }
    }
    zeroed = true;
  };

  // 3. the owned rows [n_lo, n_hi), a group of up to kSpanCap / F rows at
  // a time. A pair is a row and G of its features: four (a float4 of the
  // staging, four chains of adds side by side) where the loads are
  // float4-wide, else one. Thread tid holds the group's pairs q = i *
  // kSpanThreads + tid (row q / (F / G), features G * (q % (F / G)) on),
  // their rows' entry ranges and their sums, which it carries across the
  // group's batches; slots past the group's last pair are skipped by the
  // whole CTA. So a thread sums at most kSpanPairs / G pairs, whatever
  // the mesh: a span of 256 single-pixel rows at F 16 gives it four.
  constexpr int G = NV % 4 == 0 ? 4 : 1;
  constexpr int kSlots = kSpanPairs / G;
  const int fpr = F / G;  // pairs a row
  const float rP = 1.f / static_cast<float>(fpr);
  const int group = kSpanCap / F;
  const int batch = min(kSpanBatch, kSpanStage / F);
  for (int g0 = n_lo; g0 < n_hi; g0 += group) {
    const int g1 = min(n_hi, g0 + group);
    const int p_hi = off[g1];
    const int pairs_g = (g1 - g0) * fpr;
    int beg[kSlots], end[kSlots];
    float acc[kSlots][G];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int q = i * kSpanThreads + tid;
      beg[i] = 0;
      end[i] = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) acc[i][j] = 0.f;
      if (i * kSpanThreads < pairs_g && q < pairs_g) {
        const int r = g0 + div_small(q, fpr, rP);
        beg[i] = off[r];
        end[i] = off[r + 1];
      }
    }

    // the group's entries are CSR positions [off[g0], off[g1]): one batch
    // after the other, in order
    for (int p0 = off[g0]; p0 < p_hi; p0 += batch) {
      const int nb = min(batch, p_hi - p0);
      // a. the batch's entries, one coalesced run of order[]
      stage_ints(ent, order != nullptr ? order + p0 : nullptr, p0, nb);
      __syncthreads();
      // b. its (entry, vector) pairs, kSpanLoads loads a thread in flight,
      // staged as f32
      const int pairs = nb * vpe;
      for (int q0 = 0; q0 < pairs; q0 += kSpanLoads * kSpanThreads) {
        R x[kSpanLoads];
#pragma unroll
        for (int i = 0; i < kSpanLoads; ++i) {
          const int q = q0 + i * kSpanThreads + tid;
          if (q < pairs) {
            const int t = div_small(q, vpe, rv);
            x[i] = __ldg(reinterpret_cast<const R*>(
                values + static_cast<long long>(ent[t]) * F + (q - t * vpe) * NV));
          }
        }
        if (!zeroed) zero_fill();
#pragma unroll
        for (int i = 0; i < kSpanLoads; ++i) {
          const int q = q0 + i * kSpanThreads + tid;
          if (q < pairs) {
            const int t = div_small(q, vpe, rv);
            const int d = t * F + (q - t * vpe) * NV;
            if constexpr (NV % 4 == 0) {
#pragma unroll
              for (int v = 0; v < NV; v += 4) {
                *reinterpret_cast<float4*>(val + d + v) =
                    make_float4(elem<T>(x[i], v), elem<T>(x[i], v + 1), elem<T>(x[i], v + 2),
                                elem<T>(x[i], v + 3));
              }
            } else {
#pragma unroll
              for (int v = 0; v < NV; ++v) val[stage_index<NV>(d + v)] = elem<T>(x[i], v);
            }
          }
        }
      }
      __syncthreads();
      // c. each pair adds its row's staged values in ascending entry order,
      // reading eight entries ahead of its chains of adds
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (i * kSpanThreads >= pairs_g) break;
        const int q = i * kSpanThreads + tid;
        const int f = (q - div_small(q, fpr, rP) * fpr) * G;
        const int lo = max(beg[i], p0) - p0;
        const int hi = min(end[i], p0 + nb) - p0;
        int t = lo;
        if constexpr (G == 4) {
          float a0 = acc[i][0], a1 = acc[i][1], a2 = acc[i][2], a3 = acc[i][3];
          for (; t + 8 <= hi; t += 8) {
            float4 v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              v[j] = *reinterpret_cast<const float4*>(val + (t + j) * F + f);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              a0 = __fadd_rn(a0, v[j].x);
              a1 = __fadd_rn(a1, v[j].y);
              a2 = __fadd_rn(a2, v[j].z);
              a3 = __fadd_rn(a3, v[j].w);
            }
          }
          for (; t < hi; ++t) {
            const float4 v = *reinterpret_cast<const float4*>(val + t * F + f);
            a0 = __fadd_rn(a0, v.x);
            a1 = __fadd_rn(a1, v.y);
            a2 = __fadd_rn(a2, v.z);
            a3 = __fadd_rn(a3, v.w);
          }
          acc[i][0] = a0;
          acc[i][1] = a1;
          acc[i][2] = a2;
          acc[i][3] = a3;
        } else {
          float a = acc[i][0];
          for (; t + 8 <= hi; t += 8) {
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = val[stage_index<NV>((t + j) * F + f)];
#pragma unroll
            for (int j = 0; j < 8; ++j) a = __fadd_rn(a, v[j]);
          }
          for (; t < hi; ++t) a = __fadd_rn(a, val[stage_index<NV>(t * F + f)]);
          acc[i][0] = a;
        }
      }
      __syncthreads();
    }

    // 4. the sums of the group's non-empty rows: pair q is outputs g0 * F +
    // q * G on, stored together (16 bytes in f32, 8 in bf16)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i * kSpanThreads >= pairs_g) break;
      const int q = i * kSpanThreads + tid;
      if (end[i] > beg[i]) {
        T* const dst = out_b + static_cast<long long>(g0) * F + q * G;
        if constexpr (G == 4 && std::is_same<T, float>::value) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else if constexpr (G == 4) {
          const __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
          uint2 packed;
          packed.x = *reinterpret_cast<const unsigned*>(&lo2);
          packed.y = *reinterpret_cast<const unsigned*>(&hi2);
          *reinterpret_cast<uint2*>(dst) = packed;
        } else {
          *dst = from_f<T>(acc[i][0]);
        }
      }
    }
  }
  if (!zeroed) zero_fill();
}

template <typename T, int NV>
bool launch_spans_nv(const T* values, const int* order, const int* offsets, T* out, int batch,
                     int length, int n_out, int F, int span, cudaStream_t stream) {
  // the opt-in above 48 KiB of dynamic shared memory, once an instance
  // and the largest shared-memory carveout, so that two CTAs share an SM
  static const bool opted =
      cudaFuncSetAttribute(segment_spans_kernel<T, NV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(span_smem_bytes(kSpanMaxN))) == cudaSuccess &&
      cudaFuncSetAttribute(segment_spans_kernel<T, NV>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) == cudaSuccess;
  if (!opted) return false;
  const int ctas = max(1, (length + span - 1) / span);  // one at least, for the zeros
  const unsigned grid = static_cast<unsigned>(static_cast<long long>(batch) * ctas);
  segment_spans_kernel<T, NV><<<grid, kSpanThreads, span_smem_bytes(n_out), stream>>>(
      values, order, offsets, out, ctas, n_out, F, span);
  return true;
}

// the plan's spans layout, or false if this build does not take it
template <typename T>
bool launch_spans(const T* values, const int* order, const int* offsets, T* out, int batch,
                  int length, int n_out, int F, int vec, int span, cudaStream_t stream) {
  const auto aligned = [vec](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % (vec * sizeof(T)) == 0;
  };
  const bool ok = F >= 1 && F <= kSpanMaxF && n_out <= kSpanMaxN && length >= 0 && vec >= 1 &&
                  (vec & (vec - 1)) == 0 && vec * static_cast<int>(sizeof(T)) <= 16 &&
                  F % vec == 0 && aligned(values) && aligned(out) && span >= 1 &&
                  span * F <= kSpanCap;
  if (!ok) return false;
  switch (vec) {
    case 1:
      return launch_spans_nv<T, 1>(values, order, offsets, out, batch, length, n_out, F, span,
                                   stream);
    case 2:
      return launch_spans_nv<T, 2>(values, order, offsets, out, batch, length, n_out, F, span,
                                   stream);
    case 4:
      return launch_spans_nv<T, 4>(values, order, offsets, out, batch, length, n_out, F, span,
                                   stream);
    default:
      if constexpr (sizeof(T) == 2) {
        return launch_spans_nv<T, 8>(values, order, offsets, out, batch, length, n_out, F,
                                     span, stream);
      }
      return false;
  }
}

// ---------------------------------------------------------------- lanes

constexpr int kThreads = 256;
constexpr int kPerLane = 8;  // features a lane accumulates per pass over a row

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

// the plan's lanes layout (LPR lanes a row), or false if this build does
// not take it
template <typename T, bool VEC>
bool launch_lanes(const T* values, const int* order, const int* offsets, T* out,
                  long long rows, int n_out, int F, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 32:
      launch<T, 32, VEC>(values, order, offsets, out, rows, n_out, F, stream);
      return true;
    case 16:
      launch<T, 16, VEC>(values, order, offsets, out, rows, n_out, F, stream);
      return true;
    case 8:
      launch<T, 8, VEC>(values, order, offsets, out, rows, n_out, F, stream);
      return true;
    case 4:
      launch<T, 4, VEC>(values, order, offsets, out, rows, n_out, F, stream);
      return true;
    case 2:
      launch<T, 2, VEC>(values, order, offsets, out, rows, n_out, F, stream);
      return true;
    case 1:
      launch<T, 1, VEC>(values, order, offsets, out, rows, n_out, F, stream);
      return true;
    default:
      return false;
  }
}

// route 1: spans (vec, span); route 0: lanes (vec 8: bf16 16-byte loads,
// else 1; lanes: LPR)
template <typename T>
int run(const T* values, const int* order, const int* offsets, T* out, int batch, int length,
        int n_out, int F, int route, int vec, int span, int lanes, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n_out;
  if (rows <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  bool ok = false;
  if (route == 1) {
    ok = launch_spans<T>(values, order, offsets, out, batch, length, n_out, F, vec, span,
                         stream);
  } else if (route == 0 && vec == 8) {
    if constexpr (sizeof(T) == 2) {
      const bool aligned = F % kPerLane == 0 &&
                           reinterpret_cast<std::uintptr_t>(values) % 16 == 0 &&
                           reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
      ok = aligned && launch_lanes<T, true>(values, order, offsets, out, rows, n_out, F, lanes,
                                            stream);
    }
  } else if (route == 0 && vec == 1) {
    ok = launch_lanes<T, false>(values, order, offsets, out, rows, n_out, F, lanes, stream);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// values (B*L, F) f32; order (B*L) int32 global entry indices, or null when
// the entries are already in bucket order; offsets (B, n_out + 1) int32
// global entry positions; out (B*n_out, F) f32; B, L, n_out, F; then the
// plan (ops/segment_sum.py SegmentPlan): route (1 spans, 0 lanes), values
// a load, entries a CTA (spans), lanes a row (lanes).
int qtm_segment_sum(const float* values, const int* order, const int* offsets, float* out,
                    int batch, int length, int n_out, int F, int route, int vec, int span,
                    int lanes, cudaStream_t stream) {
  return run<float>(values, order, offsets, out, batch, length, n_out, F, route, vec, span,
                    lanes, stream);
}

// the same with values and out in bf16
int qtm_segment_sum_bf16(const void* values, const int* order, const int* offsets, void* out,
                         int batch, int length, int n_out, int F, int route, int vec, int span,
                         int lanes, cudaStream_t stream) {
  return run<bf16>(static_cast<const bf16*>(values), order, offsets, static_cast<bf16*>(out),
                   batch, length, n_out, F, route, vec, span, lanes, stream);
}

}  // extern "C"
