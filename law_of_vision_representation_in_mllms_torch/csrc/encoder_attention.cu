// Kernel 1: non-causal encoder (ViT tower) attention, [B, S, H, D] in and out.
//
// Replaces the TPU kernel `ops/encoder_attention.py` `encoder_mha` (`_kernel`).
// That kernel pads S to 128 and subtracts the padded keys' softmax mass from
// the denominator; here the tile loader zero-fills rows past S and the score
// mask drops them, so no host-side padding or transpose exists. Softmax is
// online over 64-key tiles with fp32 statistics (attention_common.cuh).
//
// Bound on the H100: at CLIP-L/14-336 (S = 577, D = 64) a head's K and V are
// 148 KB, read once per 64-row query tile, so the kernel is tensor-core and
// latency bound, not HBM bound; the [S, S] logits, which are the XLA path's
// HBM traffic, never leave the SM.
#include "attention_common.cuh"

extern "C" int lvr_encoder_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int seq, int heads, int head_dim,
                                     float scale, void* stream) {
  lvr::AttnArgs args;
  args.q = static_cast<const lvr::bf16*>(q);
  args.k = static_cast<const lvr::bf16*>(k);
  args.v = static_cast<const lvr::bf16*>(v);
  args.out = static_cast<lvr::bf16*>(out);
  args.lse = nullptr;
  args.sq = seq;
  args.skv = seq;
  args.kv_len = seq;
  args.heads = heads;
  args.kv_heads = heads;
  args.scale_log2 = scale * lvr::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return lvr::launch_flash_fwd<64, false>(args, batch, s);
    case 128:
      return lvr::launch_flash_fwd<128, false>(args, batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
