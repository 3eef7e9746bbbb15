"""Host offload on the card: the streamed moment update and the parameter
offload against the resident step, and a release straight after a step.

Off the card `ParamOffload` holds nothing and `FusedAdamW` updates its host
moments in place, so only here do the side-stream copies of the streamed
update and the parameters' moves between pinned host memory and the card
run. Marked `cuda`: each test asks for the `cuda_device` fixture, which
skips when no CUDA device is present. On a GPU machine without JAX, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py

A narrow LLaVA (a 2-layer 28 px tower and 2 decoder layers, head_dim 64)
trains 3 stage-2 steps on the flash route (kernels 1, 2, 5 and 6), fp32
weights and bf16 compute, from one seeded init. The offloaded runs must
give the resident run's losses, grad norms and parameters bit for bit: the
offload moves bytes and changes no operation.
"""

import gc

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    DEFAULT_PRECISION)
from law_of_vision_representation_in_mllms_torch.models import llama as L
from law_of_vision_representation_in_mllms_torch.models import llava as M
from law_of_vision_representation_in_mllms_torch.models.splice import (
    IGNORE_INDEX, IMAGE_TOKEN_INDEX)
from law_of_vision_representation_in_mllms_torch.models.towers import (
    TowerEntry, TowerSpec)
from law_of_vision_representation_in_mllms_torch.models.vit import ViTConfig
from law_of_vision_representation_in_mllms_torch.parallel import make_mesh
from law_of_vision_representation_in_mllms_torch.train import train_step as TS

pytestmark = pytest.mark.cuda
VOCAB = 256
STEPS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _config():
    vit = ViTConfig(image_size=28, patch_size=14, hidden_size=128,
                    num_layers=2, num_heads=2, intermediate_size=256)
    entry = TowerEntry(name="narrow", kind="vit", vit_config=vit,
                       vit_family="clip", hidden_size=128,
                       num_patches=vit.num_patches, img_size=28)
    return M.LlavaConfig(
        tower_spec=TowerSpec(entries=[entry], join="single"),
        decoder=L.LlamaConfig(vocab_size=VOCAB, hidden_size=128,
                              intermediate_size=256, num_layers=2,
                              num_heads=2, num_kv_heads=1))


def _batches(dev):
    """Right-padded rows of different lengths, the image at slot 1."""
    out = []
    for seed in range(STEPS):
        rng = np.random.RandomState(20 + seed)
        b, t = 4, 24
        ids = rng.randint(3, VOCAB, size=(b, t)).astype(np.int64)
        ids[:, 1] = IMAGE_TOKEN_INDEX
        labels = ids.copy()
        labels[:, :2] = IGNORE_INDEX
        mask = np.ones((b, t), bool)
        for r in range(1, b):
            mask[r, t - 4 * r:] = False
            labels[r, t - 4 * r:] = IGNORE_INDEX
        px = rng.randn(b, 28, 28, 3).astype(np.float32)
        out.append({"input_ids": torch.from_numpy(ids).to(dev),
                    "labels": torch.from_numpy(labels).to(dev),
                    "text_mask": torch.from_numpy(mask).to(dev),
                    "pixel_values": [torch.from_numpy(px).to(dev)]})
    return out


def _build(dev, cfg, init, **opts):
    params = M.LlavaParams(cfg, DEFAULT_PRECISION, device=dev)
    params.load_state_dict(init)
    tc = TS.TrainConfig(stage=2, learning_rate=1e-3, warmup_ratio=0.0,
                        total_steps=10, weight_decay=0.01, use_flash=True,
                        remat=True)
    mesh = make_mesh(world_size=1)
    state, opt = TS.init_sharded_train_state(params, tc, cfg, mesh,
                                             min_size=0, **opts)
    return params, state, opt, TS.make_train_step(cfg, tc, opt, mesh=mesh)


def _init(dev, cfg):
    gen = torch.Generator(device=dev).manual_seed(0)
    return M.init_params(gen, cfg, DEFAULT_PRECISION, dev).state_dict()


@pytest.mark.parametrize("opts", [
    dict(zero=0, offload_opt_state=True),
    dict(zero=0, offload_opt_state=True, offload_params=True),
    dict(zero=2, offload_opt_state=True),
    dict(zero=3, offload_opt_state=True, offload_params=True),
], ids=["moments", "moments_params", "zero2_moments", "zero3_both"])
def test_offload_is_the_resident_step_bit_for_bit(cuda_device, opts):
    cfg = _config()
    init = _init(cuda_device, cfg)
    batches = _batches(cuda_device)
    runs = []
    for o in (dict(zero=0), opts):
        params, state, opt, step = _build(cuda_device, cfg, init, **o)
        if o.get("offload_opt_state"):
            opt.copy_events = []
        metrics = []
        for b in batches:
            _, m = step(state, b)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if o.get("offload_opt_state"):
            copies = opt.copy_ms()
            # the streamed update ran: its copies each way were timed
            assert copies["h2d"] > 0 and copies["d2h"] > 0
        if o.get("offload_params"):
            # between steps every offloaded tensor is host memory
            assert all(t.device.type == "cpu"
                       for t in opt.param_offload.held)
        with TS.whole_params(params, opt):
            sd = {k: v.detach().cpu().clone()
                  for k, v in params.state_dict().items()}
        runs.append((metrics, sd))
        del params, state, opt, step
        gc.collect()
    (want_m, want_sd), (got_m, got_sd) = runs
    assert got_m == want_m
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


@pytest.mark.parametrize("how", ["release", "collect"])
def test_parameters_read_back_after_the_host_blocks_go(cuda_device, how):
    """One step with both offloads, then the pinned blocks are released at
    once (`release`: the parameters go back to the card) or the optimizer
    is dropped and collected (the finaliser unpins; the parameters stay in
    what was pinned host memory): the parameters read the values they held
    after the step."""
    cfg = _config()
    params, state, opt, step = _build(cuda_device, cfg,
                                      _init(cuda_device, cfg), zero=0,
                                      offload_opt_state=True,
                                      offload_params=True)
    step(state, _batches(cuda_device)[0])
    want = {k: v.detach().cpu().clone()
            for k, v in params.state_dict().items()}
    if how == "release":
        opt.param_offload.release()
        opt.host.release()
        assert all(t.device.type == "cuda" for t in params.parameters())
    else:
        blocks = [opt.host, opt.param_offload.host]
        finalisers = [b._unpin for b in blocks]
        del opt, step, state, blocks
        gc.collect()
        assert not any(f.alive for f in finalisers)
    for k, v in params.state_dict().items():
        assert torch.equal(v.detach().cpu(), want[k]), k
