// Kernel 1: non-causal encoder (ViT tower) attention, [B, S, H, D] in and out.
//
// Replaces the TPU kernel `ops/encoder_attention.py` `encoder_mha` (`_kernel`).
// That kernel pads S to 128 and subtracts the padded keys' softmax mass from
// the denominator; here TMA reads rows past S as zeros and the tail tile's
// mask drops them, so no host-side padding or transpose exists. The tile
// loop is kernel 2's (flash_fwd_hopper.cuh), non-causal, without the LSE.
//
// Bound on the H100: at CLIP-L/14-336 (B = 4, S = 577, H = 16, D = 64) a
// layer is 5.5 GFLOP (0.0055 ms) against 19 MB of Q, K, V and O (0.0056 ms):
// both bounds meet, and each launch is a few microseconds, so the loop's
// fill and drain count. The one-image calls of the embedding dumps (B = 1,
// S = 577 or 257) give 128-row blocks fewer than one an SM; they run in
// 64-row blocks.
#include "flash_fwd_hopper.cuh"

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
