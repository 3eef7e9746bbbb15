"""The perceiver projector and MoF tower specs of the port against the JAX
package, on the CPU in fp32.

- `PerceiverResampler` against `apply_perceiver_projector` on the JAX tree
  (within 1e-5 absolute), the trees both ways through `io.from_jax`, and
  the reference state-dict porter against the JAX `_port_perceiver`;
- `loss_fn` and the projector's gradient under `perceiver2x` (its
  attention through `flash_attention`'s autograd, the plain version on the
  CPU) and under MoF against the JAX `loss_fn` (within 1e-4 of max|ref|);
- `parse_tower_spec` of ',' specs and `encode_images`' interleave of two
  tiny towers against JAX;
- the projector files: MoF's `proj{t}.` files written by each package and
  read by the other; a perceiver's save -> load round trip to the same
  weights and outputs, while the JAX package's file of the same tree (its
  `save_projector` keeps only `layers`, with the LayerNorms as pickled
  objects) loads in neither package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.io import checkpoint as jckpt
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import perceiver as JP
from law_of_vision_representation_in_mllms_tpu.models import (
    projector as JPR, towers as JT)
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import (
    checkpoint as tckpt, from_jax)
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import (
    perceiver as TP, projector as TPR, towers as TT)
from law_of_vision_representation_in_mllms_torch.train import train_step as TS

torch.set_num_threads(1)

MOF = "debug/tiny-vit,debug/tiny-vit"
OUT_TOL = 1e-5
GRAD_REL_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perceiver(depth=2, d=32, hidden=48, seed=0):
    tree = _np_tree(JP.init_perceiver_projector(jax.random.PRNGKey(seed),
                                                depth, d, hidden))
    model = TP.PerceiverResampler(depth, d, hidden, FP32_PRECISION)
    model.load_state_dict(from_jax.perceiver_state_dict(tree))
    return tree, model


@pytest.mark.parametrize("depth,p", [(1, 16), (2, 37)])
def test_perceiver_matches_jax(depth, p):
    tree, model = _perceiver(depth)
    x = np.random.RandomState(p).randn(3, p, 32).astype(np.float32)
    want = np.asarray(jax.jit(JP.apply_perceiver_projector, static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), J_FP32))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, TP.NUM_LATENTS, 48)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    # through `build_projector`, and back to the same JAX tree
    built = TPR.build_projector(f"perceiver{depth}x", 32, 48, FP32_PRECISION)
    built.load_state_dict(model.state_dict())
    back = from_jax.projector_tree(built.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_port_perceiver_matches_jax():
    """The reference's `nn.Sequential(PerceiverResampler, Linear)` state
    dict (seeded values under its key names) through both porters."""
    depth, d, inner, hidden = 2, 8, 512, 12
    rng = np.random.RandomState(0)
    shapes = {"0.latents": (64, d), "0.norm.weight": (d,),
              "0.norm.bias": (d,), "1.weight": (hidden, d),
              "1.bias": (hidden,)}
    for i in range(depth):
        p = f"0.layers.{i}."
        shapes.update({
            p + "0.norm_media.weight": (d,), p + "0.norm_media.bias": (d,),
            p + "0.norm_latents.weight": (d,),
            p + "0.norm_latents.bias": (d,),
            p + "0.to_q.weight": (inner, d), p + "0.to_kv.weight": (2 * inner,
                                                                   d),
            p + "0.to_out.weight": (d, inner), p + "1.0.weight": (d,),
            p + "1.0.bias": (d,), p + "1.1.weight": (4 * d, d),
            p + "1.3.weight": (d, 4 * d)})
    sd = {"model.mm_projector." + k: torch.from_numpy(
        rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}
    want = from_jax.perceiver_state_dict(JPR._port_perceiver(
        sd, depth, "model.mm_projector."))
    got = TPR.port_perceiver(sd, depth, "model.mm_projector.")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # it fits the module `build_projector` makes (8 heads of 64)
    TP.PerceiverResampler(depth, d, hidden, FP32_PRECISION).load_state_dict(
        got)


def _tiny(spec, projector_type, seed=1):
    jcfg = JM.LlavaConfig.build(spec, decoder=JL.tiny(),
                                projector_type=projector_type)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg, J_FP32)
    tcfg = TM.LlavaConfig.build(spec, decoder=TL.tiny(),
                                projector_type=projector_type)
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(from_jax.llava_state_dict(_np_tree(jparams)))
    return jcfg, jparams, tcfg, params


def _pixels(cfg, b=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, e.vit_config.image_size, e.vit_config.image_size,
                      3).astype(np.float32) for e in cfg.tower_spec.entries]


@pytest.mark.parametrize("spec,projector_type", [
    ("debug/tiny-vit", "perceiver2x"), (MOF, "perceiver2x")])
def test_loss_and_projector_grad_match_jax(spec, projector_type):
    """Stage 1's loss and projector gradient (the perceiver's attention
    backward is kernels 5 and 6 on the card, their plain version here)."""
    jcfg, jparams, tcfg, params = _tiny(spec, projector_type)
    rng = np.random.RandomState(3)
    b, l = 2, 9
    ids = rng.randint(3, 250, size=(b, l)).astype(np.int32)
    ids[:, 1] = -200
    labels = ids.copy()
    labels[:, :2] = -100
    mask = np.ones((b, l), bool)
    mask[1, 6:], ids[1, 6:], labels[1, 6:] = False, 0, -100
    px = _pixels(jcfg)
    jbatch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels),
              "text_mask": jnp.asarray(mask),
              "pixel_values": [jnp.asarray(p) for p in px]}

    def jloss(projector):
        return JM.loss_fn(dict(jparams, projector=projector), jcfg, jbatch,
                          J_FP32)
    want, g = jax.jit(jax.value_and_grad(jloss))(jparams["projector"])
    TS.apply_freeze(params, stage=1)
    loss = TM.loss_fn(params, tcfg, {
        "input_ids": torch.from_numpy(ids).long(),
        "labels": torch.from_numpy(labels).long(),
        "text_mask": torch.from_numpy(mask),
        "pixel_values": [torch.from_numpy(p) for p in px]})
    loss.backward()
    assert abs(loss.item() - float(want)) <= GRAD_REL_TOL * abs(float(want))
    want_g = from_jax.projector_state_dict(_np_tree(g), "projector.")
    got_g = {n: p.grad for n, p in params.named_parameters()
             if p.grad is not None}
    assert set(got_g) == set(want_g)
    for name, w in want_g.items():
        tol = GRAD_REL_TOL * max(w.abs().max().item(), 1e-12)
        err = (got_g[name] - w).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_mof_tower_spec_matches_jax():
    spec = "openai/clip-vit-large-patch14-336,facebook/dinov2-large-336"
    for s in (spec, MOF, "debug/tiny-vit,openai/clip-vit-large-patch14"):
        j, t = JT.parse_tower_spec(s), TT.parse_tower_spec(s)
        assert t.join == j.join == "mof"
        assert [e.name for e in t.entries] == [e.name for e in j.entries]
        assert t.num_patches == j.num_patches
        with pytest.raises(ValueError, match="per-tower"):
            t.mm_hidden_size
    assert TT.parse_tower_spec(spec).num_patches == 1152
    # a perceiver over MoF: 64 latents a tower
    cfg = TM.LlavaConfig.build(spec, decoder=TL.tiny(),
                               projector_type="perceiver2x")
    assert cfg.full_num_patches == cfg.num_patches == 128


@pytest.mark.parametrize("projector_type", ["mlp2x_gelu", "perceiver2x"])
def test_mof_encode_images_interleave_matches_jax(projector_type):
    jcfg, jparams, tcfg, params = _tiny(MOF, projector_type)
    assert isinstance(params.projector, torch.nn.ModuleList)
    px = _pixels(jcfg, seed=4)
    want = np.asarray(JM.encode_images(jparams, jcfg,
                                       [jnp.asarray(p) for p in px],
                                       J_FP32))
    got = TM.encode_images(params, tcfg,
                           [torch.from_numpy(p) for p in px]).detach()
    assert got.shape == want.shape == (2, tcfg.num_patches, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_TOL, rtol=0)
    # the interleave: token 2i is tower 0's i-th, 2i + 1 tower 1's
    own = [proj(f) for proj, f in zip(params.projector, [
        tower(torch.from_numpy(p)) for tower, p in zip(params.towers, px)])]
    assert torch.equal(got[:, 0::2], own[0].detach())
    assert torch.equal(got[:, 1::2], own[1].detach())


@pytest.mark.parametrize("projector_type", ["mlp2x_gelu", "perceiver2x"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mof_projector_files_cross_read(tmp_path, writer, projector_type):
    """`proj{t}.` files. mlp: each package reads what the other's
    `save_projector` wrote. Perceiver: the port reads its own file back;
    the JAX package's file of the same trees (no latents, pickled
    LayerNorms) is refused."""
    _, jparams, tcfg, params = _tiny(MOF, projector_type)
    path = str(tmp_path)
    want = params.projector.state_dict()
    if writer == "jax":
        jckpt.save_projector(path, jparams["projector"])
        if projector_type == "perceiver2x":
            with pytest.raises(ValueError, match="latents"):
                tckpt.load_projector(path)
            return
        sd = tckpt.load_projector(path)
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), k
        return
    tckpt.save_projector(path, params.projector, proj_type=projector_type)
    assert not (tmp_path / "mm_projector.bin").exists()
    back = TM.LlavaParams(tcfg, FP32_PRECISION).projector
    back.load_state_dict(tckpt.load_projector(path))
    for k, v in want.items():
        assert torch.equal(back.state_dict()[k], v), k
    if projector_type == "mlp2x_gelu":
        got = jckpt.load_projector(path)
        assert len(got) == 2
        for g, w in zip(jax.tree.leaves(got),
                        jax.tree.leaves(_np_tree(jparams["projector"]))):
            np.testing.assert_array_equal(g, w)


def test_perceiver_save_round_trip_and_the_jax_defect(tmp_path):
    """The port saves a perceiver whole (latents, the nested LayerNorms,
    final norm, output Linear) and loads it back to the same weights and
    outputs; no `mm_projector.bin` is written. The JAX file of the same
    tree lacks the latents, final norm and Linear and holds pickled
    LayerNorms: the JAX loader and the port's both refuse it."""
    tree, model = _perceiver(depth=2)
    tckpt.save_projector(str(tmp_path / "port"), model,
                         proj_type="perceiver2x")
    with np.load(tmp_path / "port" / "mm_projector.npz") as z:
        keys = set(z.files)
    assert {"latents", "layers.1.norm_media.scale", "layers.0.to_kv",
            "final_norm.bias", "proj.kernel", "proj.bias"} <= keys
    assert not (tmp_path / "port" / "mm_projector.bin").exists()
    back = TP.PerceiverResampler(2, 32, 48, FP32_PRECISION)
    back.load_state_dict(tckpt.load_projector(str(tmp_path / "port")))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 9, 32).astype(
        np.float32))
    assert torch.equal(back(x), model(x))

    jckpt.save_projector(str(tmp_path / "jax"),
                         jax.tree.map(jnp.asarray, tree))
    with np.load(tmp_path / "jax" / "mm_projector.npz",
                 allow_pickle=True) as z:
        assert "latents" not in z.files and "proj.kernel" not in z.files
    with pytest.raises(ValueError):
        jckpt.load_projector(str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="latents"):
        tckpt.load_projector(str(tmp_path / "jax"))


def test_load_pretrained_takes_perceiver_and_mof(tmp_path):
    """`load_pretrained` applies a perceiver's or MoF's `mm_projector.npz`,
    and a reference perceiver `mm_projector.bin` through `port_perceiver`
    (the `.bin` applied last, as in the JAX package)."""
    for spec, ptype in (("debug/tiny-vit", "perceiver2x"),
                        (MOF, "mlp2x_gelu")):
        _, _, tcfg, params = _tiny(spec, ptype, seed=2)
        d = tmp_path / ptype
        tckpt.save_projector(str(d), params.projector)
        fresh = TM.LlavaParams(tcfg, FP32_PRECISION)
        tckpt.load_pretrained(str(d), fresh)
        for k, v in params.projector.state_dict().items():
            assert torch.equal(fresh.projector.state_dict()[k], v), k
    # a reference perceiver .bin: keys of nn.Sequential(resampler, Linear)
    _, _, tcfg, params = _tiny("debug/tiny-vit", "perceiver2x", seed=3)
    sd = params.projector.state_dict()
    ref = {"model.mm_projector.0.latents": sd["latents"],
           "model.mm_projector.0.norm.weight": sd["final_norm.weight"],
           "model.mm_projector.0.norm.bias": sd["final_norm.bias"],
           "model.mm_projector.1.weight": sd["proj.weight"],
           "model.mm_projector.1.bias": sd["proj.bias"]}
    names = {"norm_media": "0.norm_media", "norm_latents": "0.norm_latents",
             "ff_norm": "1.0", "to_q": "0.to_q", "to_kv": "0.to_kv",
             "to_out": "0.to_out", "ff_in": "1.1", "ff_out": "1.3"}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "layers":
            ref[f"model.mm_projector.0.layers.{parts[1]}."
                f"{names[parts[2]]}.{parts[3]}"] = v
    d = tmp_path / "bin"
    d.mkdir()
    torch.save(ref, d / "mm_projector.bin")
    fresh = TM.LlavaParams(tcfg, FP32_PRECISION)
    tckpt.load_pretrained(str(d), fresh)
    for k, v in sd.items():
        assert torch.equal(fresh.projector.state_dict()[k], v), k
