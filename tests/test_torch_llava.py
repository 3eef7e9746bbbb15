"""The port's serving slice against the JAX package: tiny LLaVA
(`debug/tiny-vit` + `mlp2x_gelu` + `llama.tiny`) on the same weights and
inputs in fp32. Generated tokens must match exactly.

The JAX side runs its Pallas paths in interpret mode (`attn_impl="encoder"`,
`use_flash=True`, `decode_attn="pallas"`). Also covered: the splice, the
adapter's `generate_until` (through `build_lmm` and a JAX `.npz` checkpoint),
the host-side data helpers and the CLI with `--device cpu`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.data import (
    conversation as jconv, image_processing as jimg, preprocess as jpre)
from law_of_vision_representation_in_mllms_tpu.eval.api import (
    Instance as JInstance)
from law_of_vision_representation_in_mllms_tpu.eval.runner import (
    build_lmm as j_build_lmm)
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import splice as JS
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.data import (
    conversation as tconv, image_processing as timg, preprocess as tpre)
from law_of_vision_representation_in_mllms_torch.eval.api import Instance
from law_of_vision_representation_in_mllms_torch.eval.runner import build_lmm
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import splice as TS

from test_torch_near_tie import check_answers, use_crc_ids

# One intra-op thread: with two, the first multi-threaded fp32 call in a
# loaded process has been seen to come out ~5e-5 off its fp64 value, over
# the tolerances below; on one thread it stays at ~5e-7.
torch.set_num_threads(1)

TINY = {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit"},
        "train": {"bf16": False}}


def _jax_tiny_llava(seed=0):
    """JAX tiny LLaVA routed through its Pallas kernels (interpret mode)."""
    cfg = JM.LlavaConfig.build("debug/tiny-vit",
                               decoder=dataclasses.replace(
                                   JL.tiny(), decode_attn="pallas"))
    entry = cfg.tower_spec.entries[0]
    entry = dataclasses.replace(entry, vit_config=dataclasses.replace(
        entry.vit_config, attn_impl="encoder"))
    cfg = dataclasses.replace(cfg, tower_spec=dataclasses.replace(
        cfg.tower_spec, entries=[entry]))
    return cfg, JM.init_params(jax.random.PRNGKey(seed), cfg, J_FP32)


@pytest.fixture(scope="module")
def tiny():
    jcfg, jparams = _jax_tiny_llava()
    tcfg = TM.LlavaConfig.build("debug/tiny-vit", decoder=TL.tiny())
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(from_jax.llava_state_dict(jparams))
    return jcfg, jparams, tcfg, params.eval()


def _batch():
    """Right-padded batch of 2 with different lengths, image at slot 1."""
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 250, size=(2, 8)).astype(np.int32)
    ids[:, 1] = JS.IMAGE_TOKEN_INDEX
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    ids[1, 5:] = 0
    px = rng.randn(2, 28, 28, 3).astype(np.float32)
    return ids, mask, px


def _jax_generate(jcfg, jparams, ids, mask, px, eos_id, n=6):
    return np.asarray(JM.generate_greedy(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
        [jnp.asarray(px)], max_new_tokens=n, eos_id=eos_id,
        precision=J_FP32, use_flash=True))


def _port_generate(tcfg, params, ids, mask, px, eos_id, n=6):
    return TM.generate_greedy(
        params, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask),
        [torch.from_numpy(px)], max_new_tokens=n, eos_id=eos_id).numpy()


def test_generate_greedy_matches_jax(tiny):
    """Exact tokens, with an EOS that one row emits mid-way (latching)."""
    jcfg, jparams, tcfg, params = tiny
    ids, mask, px = _batch()
    free = _jax_generate(jcfg, jparams, ids, mask, px, eos_id=-1)
    np.testing.assert_array_equal(
        _port_generate(tcfg, params, ids, mask, px, eos_id=-1), free)
    eos = int(free[0, 2])                      # row 0 emits it at step 2
    want = _jax_generate(jcfg, jparams, ids, mask, px, eos_id=eos)
    assert (want[0, 2:] == eos).all()
    np.testing.assert_array_equal(
        _port_generate(tcfg, params, ids, mask, px, eos_id=eos), want)


def test_encode_images_and_prefill_logits_match_jax(tiny):
    jcfg, jparams, tcfg, params = tiny
    ids, mask, px = _batch()
    want = JM.encode_images(jparams, jcfg, [jnp.asarray(px)], J_FP32)
    with torch.inference_mode():
        got = TM.dump_image_embeds(params, tcfg, [torch.from_numpy(px)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    pre = TM.prefill(params, tcfg, torch.from_numpy(ids).long(),
                     torch.from_numpy(mask), [torch.from_numpy(px)],
                     max_new_tokens=2)
    assert pre.l_out == 8 + tcfg.num_patches - 1
    assert pre.n_valid.tolist() == [8 + 15, 5 + 15]
    assert np.isfinite(pre.logits.numpy()).all()


def test_concat_towers_match_jax():
    """'.' spec: two towers, channel concat, one shared projector."""
    spec = "debug/tiny-vit.debug/tiny-vit"
    jcfg = JM.LlavaConfig.build(spec, decoder=JL.tiny())
    jparams = JM.init_params(jax.random.PRNGKey(3), jcfg, J_FP32)
    tcfg = TM.LlavaConfig.build(spec, decoder=TL.tiny())
    assert tcfg.tower_spec.join == "concat"
    assert tcfg.tower_spec.mm_hidden_size == 64
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(from_jax.llava_state_dict(jparams))
    rng = np.random.RandomState(4)
    px = [rng.randn(2, 28, 28, 3).astype(np.float32) for _ in range(2)]
    want = JM.encode_images(jparams, jcfg, [jnp.asarray(x) for x in px],
                            J_FP32)
    with torch.inference_mode():
        got = TM.encode_images(params, tcfg, [torch.from_numpy(x)
                                              for x in px])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


def test_splice_matches_jax():
    for trial in range(6):
        rng = np.random.RandomState(100 + trial)
        b, l, p = 3, int(rng.randint(4, 12)), int(rng.randint(1, 6))
        ids = rng.randint(0, 50, size=(b, l)).astype(np.int32)
        labels = rng.randint(0, 50, size=(b, l)).astype(np.int32)
        mask = np.ones((b, l), bool)
        for r in range(b):
            n = int(rng.randint(2, l + 1))
            mask[r, n:] = False
            if r < 2:                          # row 2 stays text-only
                ids[r, rng.randint(0, n)] = JS.IMAGE_TOKEN_INDEX
        want = JS.splice_plan(jnp.asarray(ids), jnp.asarray(labels),
                              jnp.asarray(mask), p)
        got = TS.splice_plan(torch.from_numpy(ids).long(),
                             torch.from_numpy(labels).long(),
                             torch.from_numpy(mask), p)
        for name in TS.Spliced._fields:
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=f"{name}, trial {trial}")
        emb = rng.randn(b, l, 4).astype(np.float32)
        img = rng.randn(b, p, 4).astype(np.float32)
        np.testing.assert_array_equal(
            TS.splice_embeds(got, torch.from_numpy(emb),
                             torch.from_numpy(img)).numpy(),
            np.asarray(JS.splice_embeds(want, jnp.asarray(emb),
                                        jnp.asarray(img))))


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 255, (40 + 8 * i, 36, 3),
                                        dtype=np.uint8)) for i in range(n)]


def test_data_helpers_match_jax():
    tok_j, tok_t = jpre.SimpleTokenizer(256), tpre.SimpleTokenizer(256)
    prompt = tconv.get_template("v1").prompt_for_generation(
        [("human", "<image>\nwhat is shown here ?")])
    assert prompt == jconv.get_template("v1").prompt_for_generation(
        [("human", "<image>\nwhat is shown here ?")])
    assert tpre.tokenizer_image_token(prompt, tok_t) == \
        jpre.tokenizer_image_token(prompt, tok_j)
    for name in ("debug/tiny-vit", "openai/clip-vit-large-patch14-336",
                 "google/siglip-base-patch16-224"):
        pt, pj = timg.processor_for_tower(name), jimg.processor_for_tower(name)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        for img in _images(2):
            np.testing.assert_array_equal(
                timg.preprocess_image(img, pt, pad_square=True),
                jimg.preprocess_image(img, pj, pad_square=True))


def _requests(cls, images, max_new=5):
    prompts = ["describe the image in detail", "what color is it"]
    return [cls("generate_until", {}, i, "t",
                (p, {"max_new_tokens": max_new, "until": ["\n"]}), [im])
            for i, (p, im) in enumerate(zip(prompts, images))]


def test_generate_until_matches_jax(tmp_path):
    """JAX `build_lmm` weights -> `param_io` .npz -> the port's `build_lmm`
    (`model.checkpoint`); both adapters answer the same requests."""
    jcfg = JRunConfig.from_dict(
        {"model": dict(TINY["model"], tower_attn_impl="encoder",
                       decode_attn="pallas"), "train": TINY["train"]})
    jlmm = j_build_lmm(jcfg)
    path = str(tmp_path / "llava.npz")
    jio.save_params(path, jlmm.params)
    lmm = build_lmm(RunConfig.from_dict(
        {"model": dict(TINY["model"], checkpoint=path),
         "train": TINY["train"]}), device="cpu")
    images = _images(2, seed=1)
    # CRC ids (the same prompts in every process); a differing answer must
    # part from the JAX one at a near tie of the JAX logits
    use_crc_ids(jlmm, lmm)
    want = jlmm.generate_until(_requests(JInstance, images))
    got = lmm.generate_until(_requests(Instance, images))
    check_answers(jlmm, _requests(JInstance, images), want, got)
    # a preprocessed HWC array is accepted in place of a PIL image
    arrays = [timg.preprocess_image(im, lmm.processors[0], pad_square=True)
              for im in images]
    assert lmm.generate_until(_requests(Instance, arrays)) == got


def test_cli_generate_on_cpu(capsys):
    argv = ["generate", "--prompt", "what is in the picture",
            "--max-new-tokens", "4", "--device", "cpu"]
    for k, v in TINY["model"].items():
        argv += ["--set", f"model.{k}={v}"]
    argv += ["--set", "train.bf16=false"]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out.strip()
    lmm = build_lmm(RunConfig.from_dict(TINY), device="cpu")
    inst = Instance("generate_until", {}, 0, "cli",
                    ("what is in the picture",
                     {"max_new_tokens": 4, "temperature": 0.0,
                      "top_p": 1.0}), [])
    assert printed == lmm.generate_until([inst])[0]
    assert printed.startswith("t")
    # sampling is ported: `--temperature` draws from the adapter's
    # generator, seeded by model.sample_seed (0), so a fresh adapter with
    # the same seed gives the same answer
    assert cli.main(argv + ["--temperature", "0.5", "--top-p", "0.9"]) == 0
    sampled = capsys.readouterr().out.strip()
    inst = Instance("generate_until", {}, 0, "cli",
                    ("what is in the picture",
                     {"max_new_tokens": 4, "temperature": 0.5,
                      "top_p": 0.9}), [])
    assert sampled == build_lmm(RunConfig.from_dict(TINY),
                                device="cpu").generate_until([inst])[0]


def test_cli_serve_inflight_answers_a_chat_completion(monkeypatch):
    """`serve --inflight --slots 2 --device cpu` on the tiny LLaVA answers a
    chat completion through the continuous-batching engine (the wave worker
    is not built), as the adapter's `generate_until` answers it."""
    import json
    import threading
    import urllib.request
    from law_of_vision_representation_in_mllms_torch import serve
    seen = {}
    real_forever = serve.LMMServer.serve_forever

    def forever(self):
        threading.Thread(target=real_forever, args=(self,),
                         daemon=True).start()
        payload = {"max_tokens": 4, "messages": [
            {"role": "user", "content": "what is in the picture"}]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/v1/chat/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            seen["answer"] = json.loads(r.read())[
                "choices"][0]["message"]["content"]
        seen["worker"] = self.worker
        seen["lmm"] = self.lmm
        raise KeyboardInterrupt
    monkeypatch.setattr(serve.LMMServer, "serve_forever", forever)
    argv = ["serve", "--inflight", "--slots", "2", "--gen-cap", "8",
            "--prompt-cap", "64", "--device", "cpu", "--port", "0"]
    for k, v in TINY["model"].items():
        argv += ["--set", f"model.{k}={v}"]
    assert cli.main(argv + ["--set", "train.bf16=false"]) == 0
    engine = seen["worker"].engine
    assert (engine.n_slots, engine.gen_cap, engine.prompt_cap) == (2, 8, 64)
    assert engine.completions == 1 and engine._stop     # shut down
    inst = Instance("generate_until", {}, 0, "serve",
                    ("what is in the picture", {"max_new_tokens": 4}), [])
    assert seen["answer"] == seen["lmm"].generate_until([inst])[0]
    assert seen["answer"].startswith("t")


def test_cli_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["generate", "--prompt", "hi"])


def test_init_params_is_seeded_and_samples_each_weight_once():
    """Decoder weights ~ N(0, 0.02) as the JAX init draws them; tower and
    projector keep their own inits; one seed gives one set of weights."""
    cfg = TM.LlavaConfig.build("debug/tiny-vit", decoder=TL.tiny())

    def init(seed):
        return TM.init_params(torch.Generator().manual_seed(seed), cfg,
                              FP32_PRECISION, "cpu").state_dict()
    a, b, c = init(0), init(0), init(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.embed"], c["decoder.embed"])
    for name in ("decoder.embed", "decoder.lm_head.weight",
                 "decoder.layers.0.wq.weight", "decoder.layers.1.down.weight"):
        assert abs(a[name].std().item() - 0.02) < 0.002, name
    assert (a["decoder.layers.0.rms1"] == 1).all()
    # the tower's Dense keeps the lecun-normal scale 1/sqrt(fan_in)
    std = a["towers.0.encoder.blocks.0.q.weight"].std().item()
    assert abs(std - 32 ** -0.5) < 0.03


def test_unported_options_raise():
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        parse_tower_spec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_tower_spec("debug/tiny-vit,debug/tiny-vit")
    # DiT and SD3 are ported: a diffusion entry of 16 x 16 tokens at 512 px
    entry = parse_tower_spec("facebook/DiT-XL-2-512").entries[0]
    assert (entry.kind, entry.num_patches, entry.hidden_size) == (
        "diffusion", 256, 4608)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_lmm(RunConfig.from_dict(
            {"model": dict(TINY["model"], visual_keep=0.5)}), device="cpu")
    # the serving backends are ported: every gen_backend builds, an
    # unknown one is a ValueError
    for backend in ("chunked", "speculative"):
        lmm = build_lmm(RunConfig.from_dict(
            {"model": dict(TINY["model"], gen_backend=backend),
             "train": TINY["train"]}), device="cpu")
        assert lmm.gen_backend == backend
    with pytest.raises(ValueError, match="gen_backend"):
        build_lmm(RunConfig.from_dict(
            {"model": dict(TINY["model"], gen_backend="no_such_backend"),
             "train": TINY["train"]}), device="cpu")
    # what no longer raises: the JAX route names build, an unknown one is a
    # ValueError (not a not-ported error)
    for key, value in (("tower_attn_impl", "encoder2_nt"),
                       ("tower_attn_impl", "flash"),
                       ("decode_attn", "pallas_stacked")):
        lmm = build_lmm(RunConfig.from_dict(
            {"model": dict(TINY["model"], **{key: value}),
             "train": TINY["train"]}), device="cpu")
        if key == "decode_attn":
            assert lmm.cfg.decoder.decode_attn == value
        else:
            assert lmm.cfg.tower_spec.entries[0].vit_config.attn_impl == value
    for key in ("tower_attn_impl", "decode_attn"):
        with pytest.raises(ValueError, match=key.replace("tower_", "")):
            build_lmm(RunConfig.from_dict(
                {"model": dict(TINY["model"], **{key: "no_such_route"}),
                 "train": TINY["train"]}), device="cpu")


@pytest.mark.parametrize("decode_attn", ["xla", "pallas", "pallas_stacked"])
def test_decode_attn_routes_match_jax(tiny, decode_attn):
    """Every `model.decode_attn` name: the JAX decoder under that route (its
    Pallas decode kernels in interpret mode) and the port, whose every route
    is kernel 3's wrapper, generate the same tokens."""
    jcfg, jparams, tcfg, params = tiny
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(
        jcfg.decoder, decode_attn=decode_attn))
    tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(
        tcfg.decoder, decode_attn=decode_attn))
    ids, mask, px = _batch()
    want = _jax_generate(jcfg, jparams, ids, mask, px, eos_id=-1, n=5)
    got = _port_generate(tcfg, params, ids, mask, px, eos_id=-1, n=5)
    np.testing.assert_array_equal(got, want)
