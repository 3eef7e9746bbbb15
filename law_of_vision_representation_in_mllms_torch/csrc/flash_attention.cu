// Kernel 2: flash-attention forward for the decoder prefill, with GQA.
//
// Replaces the TPU kernel `ops/flash_attention.py` `_flash_fwd_lse`
// (`_fwd_lse_kernel`), the forward of `flash_attention_trainable` that the
// prefill reaches through `flash_mha_trainable`. Queries are [B, Sq, H, D],
// keys and values [B, Skv, KV, D]; query head h reads kv head h / (H / KV)
// inside the kernel, which replaces the `jnp.repeat` of K and V before the
// TPU call. Optional causal mask (key j <= query i), a `kv_len` tail mask and
// an optional fp32 natural-log LSE output [B, H, Sq]. With `slopes` (fp32
// [B, H], MPT's ALiBi) logit (i, j) gains slope[b, h]·(j − (kv_len − 1)) inside
// the kernel, as the TPU kernel's `alibi` flag does; no bias tensor exists.
// Head sizes 64 and 128 take every form; 40, 72, 80 and 160 (the diffusion
// towers' attention, `flash_mha` through `flash_attention_bhsd` in the JAX
// package: the UNets' 40, 80 and 160, DiT-XL/2's 72) are non-causal without
// ALiBi, on a tile of D rounded up to 64.
//
// Bound on the H100: at the Vicuna-7B prefill (B = 4, S = 640, kv_len 600,
// H = 32, D = 128, causal) a layer is 13.4 GFLOP against 81 MB of Q, K, V and
// O (0.0243 ms, bytes); at MPT-7B's B = 2, S = 2,048, 68.7 GFLOP (0.0695 ms,
// operations). The tile loop is flash_fwd_hopper.cuh: TMA-fed,
// warp-specialised wgmma with P in registers, ping-pong of two consumer
// warpgroups, and the mask only on the diagonal and tail tiles.
#include "flash_fwd_hopper.cuh"

extern "C" int lvr_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, void* lse, const void* slopes,
                                   int batch, int seq_q, int seq_kv, int heads,
                                   int kv_heads, int head_dim, int kv_len,
                                   int causal, float scale, void* stream) {
  lvr::AttnArgs args;
  args.q = static_cast<const lvr::bf16*>(q);
  args.k = static_cast<const lvr::bf16*>(k);
  args.v = static_cast<const lvr::bf16*>(v);
  args.out = static_cast<lvr::bf16*>(out);
  args.lse = static_cast<float*>(lse);
  args.sq = seq_q;
  args.skv = seq_kv;
  args.kv_len = kv_len;
  args.heads = heads;
  args.kv_heads = kv_heads;
  args.scale_log2 = scale * lvr::kLog2e;
  args.slopes = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool alibi = slopes != nullptr;
  if (head_dim == 64) {
    if (alibi) {
      return causal ? lvr::launch_flash_fwd<64, true, true>(args, batch, s)
                    : lvr::launch_flash_fwd<64, false, true>(args, batch, s);
    }
    return causal ? lvr::launch_flash_fwd<64, true>(args, batch, s)
                  : lvr::launch_flash_fwd<64, false>(args, batch, s);
  }
  if (head_dim == 128) {
    if (alibi) {
      return causal ? lvr::launch_flash_fwd<128, true, true>(args, batch, s)
                    : lvr::launch_flash_fwd<128, false, true>(args, batch, s);
    }
    return causal ? lvr::launch_flash_fwd<128, true>(args, batch, s)
                  : lvr::launch_flash_fwd<128, false>(args, batch, s);
  }
  // the diffusion towers' head sizes (SD1.5's 320 / 640 / 1280 channels
  // over 8 heads, DiT-XL/2's 1,152 over 16): non-causal, no bias, on a tile
  // of D rounded up to 64
  if (!causal && !alibi) {
    switch (head_dim) {
      case 40:
        return lvr::launch_flash_fwd<40, false>(args, batch, s);
      case 72:
        return lvr::launch_flash_fwd<72, false>(args, batch, s);
      case 80:
        return lvr::launch_flash_fwd<80, false>(args, batch, s);
      case 160:
        return lvr::launch_flash_fwd<160, false>(args, batch, s);
      default:
        break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The query rows a block of the last forward launched through
// `lvr_flash_attention` took: 64 or 128 (0 before the first launch).
extern "C" int lvr_flash_attention_block_rows(void) {
  return lvr::last_fwd_rows.load(std::memory_order_relaxed);
}
