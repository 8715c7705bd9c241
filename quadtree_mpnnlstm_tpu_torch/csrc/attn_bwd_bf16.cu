// K4's bf16 entry point (attn_bwd.cuh).

#include "attn_bwd.cuh"

// qtm_attn_bwd (attn_bwd.cu) with q, k, v, We, g, dq, dk, dv and dWe in
// bf16 (keep, attr, dlog, used and the dWe partials stay f32)
extern "C" int qtm_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* we,
                                 const float* keep, const int* s0, const int* src_rel,
                                 const int* dst_rel, const float* attr, const int* live,
                                 const void* g, const int* order, const int* offsets, void* dq,
                                 void* dk, void* dv, float* dlog, float* used, float* dwe_part,
                                 void* dwe, int B, int meta_b, int T, int EB, int NT, int SW,
                                 int n_max, int H, int D, int A, int KH, int run, int lanes_head,
                                 int heads_item, int lanes_item, int slices, int warps, int rows,
                                 int chunk, int units, float scale, void* stream, int* geometry) {
  const auto in = [](const void* x) { return static_cast<const bf16*>(x); };
  const auto out = [](void* x) { return static_cast<bf16*>(x); };
  return attn_bwd<bf16>(in(q), in(k), in(v), in(we), keep, s0, src_rel, dst_rel, attr, live,
                        in(g), order, offsets, out(dq), out(dk), out(dv), dlog, used, dwe_part,
                        out(dwe), B,
                        meta_b, T, EB, NT, SW, n_max, H, D, A, KH, run, lanes_head, heads_item,
                        lanes_item, slices, warps, rows, chunk, units, scale, stream, geometry);
}

