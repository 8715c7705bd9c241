// K4's f32 entry point (attn_bwd.cuh).

#include "attn_bwd.cuh"

// K4: the plan run .. chunk (ops/attn.py bwd_plan); order (M*T*EB) and
// offsets (M, n_max + 1): the source-sorted slot view (ops/attn.py
// slot_view) of the M = meta_b meshes (B, or 1 for a shared mesh, as the
// windows); dlog and used (B, T*EB, H) scratch; dwe_part (units, A, H*D)
// f32 scratch, units = B * T * ceil(NT / rows) * slices; dwe (A, H*D) the
// partials' sum (written only when units > 0). geometry, when not null,
// is a host array of 9 ints that receives what was launched: the first
// kernel's CTAs (its dWe partials, the first CTAs of dwe_part), units,
// threads a CTA, shared bytes, run, chunk, 16-byte rows, 16-byte window
// copies, the second kernel's CTAs.
extern "C" int qtm_attn_bwd(const float* q, const float* k, const float* v, const float* we,
                            const float* keep, const int* s0, const int* src_rel,
                            const int* dst_rel, const float* attr, const int* live,
                            const float* g, const int* order, const int* offsets, float* dq,
                            float* dk, float* dv, float* dlog, float* used, float* dwe_part,
                            float* dwe, int B, int meta_b, int T, int EB, int NT, int SW,
                            int n_max, int H, int D, int A, int KH, int run, int lanes_head,
                            int heads_item, int lanes_item, int slices, int warps, int rows,
                            int chunk, int units, float scale, void* stream, int* geometry) {
  return attn_bwd<float>(q, k, v, we, keep, s0, src_rel, dst_rel, attr, live, g, order, offsets,
                         dq, dk, dv, dlog, used, dwe_part, dwe, B, meta_b, T, EB, NT, SW, n_max,
                         H, D, A, KH, run, lanes_head, heads_item, lanes_item, slices, warps,
                         rows, chunk, units, scale, stream, geometry);
}

