// K3's bf16 entry point (attn.cuh).

#include "attn.cuh"

// qtm_attn_fwd (attn.cu) with q, k, v, We and out in bf16 (keep and attr
// stay f32)
extern "C" int qtm_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* we,
                                 const float* keep, const int* s0, const int* src_rel,
                                 const int* dst_rel, const float* attr, const int* live, void* out,
                                 int B, int meta_b, int T, int EB, int NT, int SW, int n_max,
                                 int H, int D, int A, int KH, int run, int lanes_head,
                                 int heads_item, int lanes_item, int slices, int warps, int rows,
                                 int chunk, float scale, void* stream, int* geometry) {
  return attn_fwd<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<const bf16*>(we), keep, s0,
                        src_rel, dst_rel, attr, live, static_cast<bf16*>(out), B, meta_b, T, EB,
                        NT, SW, n_max, H, D, A, KH, run, lanes_head, heads_item, lanes_item,
                        slices, warps, rows, chunk, scale, stream, geometry);
}

