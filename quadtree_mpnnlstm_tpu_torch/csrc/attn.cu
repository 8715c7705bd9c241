// K3's f32 entry point (attn.cuh).

#include "attn.cuh"

// run .. chunk: K3's plan (ops/attn.py fwd_plan). geometry, when not null,
// is a host array of 8 ints that receives what was launched: CTAs, row
// groups, threads a CTA, shared bytes, run, chunk, 16-byte rows, 16-byte
// window copies.
extern "C" int qtm_attn_fwd(const float* q, const float* k, const float* v, const float* we,
                            const float* keep, const int* s0, const int* src_rel,
                            const int* dst_rel, const float* attr, const int* live, float* out,
                            int B, int meta_b, int T, int EB, int NT, int SW, int n_max, int H,
                            int D, int A, int KH, int run, int lanes_head, int heads_item,
                            int lanes_item, int slices, int warps, int rows, int chunk,
                            float scale, void* stream, int* geometry) {
  return attn_fwd<float>(q, k, v, we, keep, s0, src_rel, dst_rel, attr, live, out, B, meta_b, T,
                         EB, NT, SW, n_max, H, D, A, KH, run, lanes_head, heads_item, lanes_item,
                         slices, warps, rows, chunk, scale, stream, geometry);
}

