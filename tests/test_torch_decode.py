"""The port's chunked greedy decoder (`models/decode.py`) against the JAX
`ChunkedGreedyDecoder` and the port's own `generate_greedy`, token for token,
on the tiny LLaVA (`debug/tiny-vit` + `mlp2x_gelu` + `llama.tiny`) with the
same weights (`io/from_jax.py`) in fp32 on the CPU.

On the CPU the decoder runs its chunk function eagerly (no graph is
captured); the chunk is the function a CUDA graph captures on the card
(`tests/test_torch_cuda_kernels.py` holds a replay to the eager steps
there). Also: the decoder's forward at a cache slot held on the device
equals the forward at a Python-int slot, dense and int8 cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models.decode import (
    ChunkedGreedyDecoder as JDecoder)
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models.decode import (
    ChunkedGreedyDecoder)
from law_of_vision_representation_in_mllms_torch.models.splice import (
    IMAGE_TOKEN_INDEX)

# one intra-op thread, as every test file of the port (tests/
# test_torch_llava.py says why)
torch.set_num_threads(1)


def tiny_models(seed=0, kv_quant=None):
    """The JAX tiny LLaVA and the port's, on the JAX weights."""
    jcfg = JM.LlavaConfig.build("debug/tiny-vit", decoder=JL.tiny(),
                                kv_quant=kv_quant)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg, J_FP32)
    tcfg = TM.LlavaConfig.build("debug/tiny-vit", decoder=TL.tiny(),
                                kv_quant=kv_quant)
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(from_jax.llava_state_dict(jparams))
    return jcfg, jparams, tcfg, params.eval()


def ragged_batch(seed=0, b=3, l=8, same_rows=False):
    """Right-padded rows of different lengths, the image at slot 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 250, size=(b, l)).astype(np.int32)
    if same_rows:
        ids[:] = ids[:1]
    ids[:, 1] = IMAGE_TOKEN_INDEX
    mask = np.ones((b, l), bool)
    if not same_rows:
        for r in range(1, b):
            mask[r, l - 1 - r:] = False
            ids[r, l - 1 - r:] = 0
    px = rng.randn(b, 28, 28, 3).astype(np.float32)
    if same_rows:
        px[:] = px[:1]
    return ids, mask, px


def port_args(batch):
    ids, mask, px = batch
    return (torch.from_numpy(ids).long(), torch.from_numpy(mask),
            [torch.from_numpy(px)])


def jax_args(batch):
    ids, mask, px = batch
    return jnp.asarray(ids), jnp.asarray(mask), [jnp.asarray(px)]


def port_greedy(tcfg, params, batch, max_new, eos_id):
    return TM.generate_greedy(params, tcfg, *port_args(batch),
                              max_new_tokens=max_new, eos_id=eos_id).numpy()


def jax_chunked(jcfg, jparams, batch, max_new, eos_id, chunk):
    dec = JDecoder(jparams, jcfg, eos_id=eos_id, precision=J_FP32,
                   chunk=chunk, use_flash=True)
    return np.asarray(dec.generate(*jax_args(batch),
                                   max_new_tokens=max_new))


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


@pytest.mark.parametrize("chunk", [3, 4, 16])
def test_chunked_matches_jax_and_greedy(tiny, chunk):
    """Uneven tail (3), even (4) and one oversized chunk (16), on a ragged
    batch whose row 0 emits eos mid-way (its later tokens latch to eos)."""
    jcfg, jparams, tcfg, params = tiny
    batch = ragged_batch()
    max_new = 10
    eos = int(port_greedy(tcfg, params, batch, 3, eos_id=-1)[0, 2])
    want = jax_chunked(jcfg, jparams, batch, max_new, eos, chunk)
    assert (want[0, 2:] == eos).all() and not (want[1:] == eos).all()
    dec = ChunkedGreedyDecoder(params, tcfg, eos_id=eos, chunk=chunk)
    got = dec.generate(*port_args(batch), max_new_tokens=max_new)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port_greedy(tcfg, params, batch, max_new, eos), want)
    # the CPU runs the chunk eagerly: every chunk ran, nothing captured
    assert dec.captures == 0 and dec.replays == -(-max_new // chunk)


def test_chunked_early_exit_pads_eos(tiny):
    """Every row done after the first chunk of three: the decoder stops
    there and pads with eos, as the JAX one does."""
    jcfg, jparams, tcfg, params = tiny
    batch = ragged_batch(seed=1, b=2, same_rows=True)
    eos = int(port_greedy(tcfg, params, batch, 2, eos_id=-1)[0, 1])
    want = jax_chunked(jcfg, jparams, batch, 12, eos, 4)
    assert (want[:, 1:] == eos).all()
    dec = ChunkedGreedyDecoder(params, tcfg, eos_id=eos, chunk=4)
    got = dec.generate(*port_args(batch), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert dec.replays == 1


def test_chunked_decoder_reuses_keys(tiny):
    """One decoder over two keys and back: each key keeps its static
    tensors, a key used again (its cache zeroed by the prefill) gives the
    tokens of a fresh decoder."""
    _, _, tcfg, params = tiny
    dec = ChunkedGreedyDecoder(params, tcfg, eos_id=-1, chunk=4)
    a, b, c = (ragged_batch(seed=2, l=8), ragged_batch(seed=3, l=12),
               ragged_batch(seed=4, l=8))
    for batch in (a, b, c, a):
        got = dec.generate(*port_args(batch), max_new_tokens=7)
        np.testing.assert_array_equal(
            got.numpy(), port_greedy(tcfg, params, batch, 7, -1))
    assert sorted(dec._keys) == [(3, 8, 8), (3, 12, 8)]


@pytest.mark.parametrize("max_keys", [1, 2])
def test_chunked_decoder_keeps_at_most_max_keys(tiny, max_keys):
    """Four keys in turn, then the first again: the decoder keeps only its
    `max_keys` most recently used keys (an older key's static tensors and
    graph are dropped), a dropped key comes back fresh with the same tokens,
    and the replay count goes on across keys."""
    _, _, tcfg, params = tiny
    dec = ChunkedGreedyDecoder(params, tcfg, eos_id=-1, chunk=4)
    dec.max_keys = max_keys
    batches = [ragged_batch(seed=8, b=2, l=8), ragged_batch(seed=9, l=8),
               ragged_batch(seed=10, l=12), ragged_batch(seed=11, l=16)]
    seen = []
    for batch in batches + batches[:1]:
        got = dec.generate(*port_args(batch), max_new_tokens=5)
        np.testing.assert_array_equal(
            got.numpy(), port_greedy(tcfg, params, batch, 5, -1))
        b, l = batch[0].shape
        seen.append((b, l, 8))
        assert list(dec._keys) == seen[-max_keys:]
    assert dec.replays == 2 * len(seen)


def test_chunked_int8_kv_cache_matches_jax():
    """`kv_quant=int8`: codes and scales quantised on write at the
    device-held slot, read by the int8 branch of the decode attention."""
    jcfg, jparams, tcfg, params = tiny_models(seed=5, kv_quant="int8")
    batch = ragged_batch(seed=6)
    want = jax_chunked(jcfg, jparams, batch, 9, -1, 4)
    dec = ChunkedGreedyDecoder(params, tcfg, eos_id=-1, chunk=4)
    got = dec.generate(*port_args(batch), max_new_tokens=9)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port_greedy(tcfg, params, batch, 9, -1), want)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("s", [1, 3])
def test_device_cache_index_equals_int_slot(quant, s):
    """A forward of s tokens at a slot held on the device ([B] first slots
    or [B, s] slots) writes the same cache and gives the same hidden states
    as the forward at the Python-int slot."""
    cfg = TL.tiny()
    torch.manual_seed(7)
    model = TL.LlamaModel(cfg, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    init_weights(model, torch.Generator().manual_seed(7))
    b, t, slot = 2, 12, 5
    emb = torch.randn(b, s, cfg.hidden_size)
    pos = torch.tensor([[5], [3]]) + torch.arange(s)[None]
    valid = torch.ones(b, t, dtype=torch.bool)
    valid[1, 4] = False

    def cache():
        c = TL.init_cache(cfg, b, t, torch.float32, quant=quant)
        g = torch.Generator().manual_seed(8)
        for layer in c:
            for x in layer:
                x.copy_(torch.randint(-50, 50, x.shape, generator=g)
                        if x.dtype == torch.int8 else
                        torch.rand(x.shape, generator=g))
        return c
    with torch.inference_mode():
        ref_cache = cache()
        want, _ = model(emb, pos, attn_mask=valid, cache=ref_cache,
                        cache_index=slot)
        for index in (torch.full((b,), slot),
                      (slot + torch.arange(s))[None].expand(b, s)):
            got_cache = cache()
            got, _ = model(emb, pos, attn_mask=valid, cache=got_cache,
                           cache_index=index)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            for lw, lg in zip(ref_cache, got_cache):
                for xw, xg in zip(lw, lg):
                    assert torch.equal(xw, xg)
