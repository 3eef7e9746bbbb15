"""One rank of a `gloo` world that runs the port's parallel training cases
for tests/test_torch_parallel_train.py:

    python tests/torch_parallel_worker.py JOB.json RANK

JOB.json names the world size, a `FileStore` path and the cases; each case
writes `<out>/<name>.rank<RANK>.pt`: every rank's per-step metrics, and on
rank 0 the whole trained state (gathered) and FusedAdamW's gathered second
moments; a ring case every rank's output and q / k / v gradient shards of
both routes, a context-parallel decoder case every rank's hidden shard and
the loss and decoder gradients summed over the ranks. This module imports
the port and torch only: the JAX references are computed by the test
process.
"""

import json
import os
import sys
import zlib

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from law_of_vision_representation_in_mllms_torch.core.config import (  # noqa: E402
    RunConfig)
from law_of_vision_representation_in_mllms_torch.core.precision import (  # noqa: E402
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.data import (  # noqa: E402
    preprocess)
from law_of_vision_representation_in_mllms_torch.models import (  # noqa: E402
    llama as TL, llava as TM, lora as TLora, switch as TSw, towers as TT,
    vit as TV)
from law_of_vision_representation_in_mllms_torch.ops import (  # noqa: E402
    quant as TQ, ring_attention as TR)
from law_of_vision_representation_in_mllms_torch.parallel import (  # noqa: E402
    comm, data_rows, make_mesh, shard_batch)
from law_of_vision_representation_in_mllms_torch.train import (  # noqa: E402
    runner, train_step as TS)

torch.set_num_threads(1)

# the tiny LLaVA of tests/test_torch_train.py:_configs
DECODER = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=64)


def crc_encode(self, text, add_special_tokens=False):
    """Hash-tokenizer ids that every process agrees on (`hash` of a str
    changes with PYTHONHASHSEED)."""
    ids = [3 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
           for w in text.split()]
    return [self.bos_token_id] + ids if add_special_tokens else ids


def tiny_config(decoder=None):
    """The tiny LLaVA; `decoder`: fields of its decoder to change."""
    vit = TV.ViTConfig(image_size=14, patch_size=7, hidden_size=16,
                       num_layers=2, num_heads=2, intermediate_size=32)
    entry = TT.TowerEntry(name="tiny", kind="vit", vit_config=vit,
                          vit_family="clip", hidden_size=16,
                          num_patches=vit.num_patches)
    return TM.LlavaConfig(tower_spec=TT.TowerSpec(entries=[entry],
                                                  join="single"),
                          decoder=TL.tiny(**dict(DECODER, **(decoder or {}))))


def build_params(case, cfg):
    params = TM.LlavaParams(cfg, FP32_PRECISION)
    params.load_state_dict(torch.load(case["init"]))
    if case.get("bits"):
        TQ.quantize_decoder(params.decoder, bits=case["bits"])
    if case.get("lora"):
        lora = TLora.LoraAdapters(cfg.decoder, TLora.LoraConfig(
            rank=case["lora"]["rank"], alpha=case["lora"]["alpha"]),
            FP32_PRECISION)
        lora.load_state_dict(torch.load(case["lora"]["init"]))
        params.lora = lora
    if case.get("switch"):
        params.switch = TSw.Switch(cfg.decoder.hidden_size, FP32_PRECISION)
        params.switch.load_state_dict(torch.load(case["switch"]))
    return params.eval()


def run_steps(case, rank):
    """`make_train_step` over the case's global batches on its mesh."""
    cfg = tiny_config(case.get("decoder"))
    params = build_params(case, cfg)
    mesh = make_mesh(n_data=case["n_data"], n_model=case["n_model"])
    tcfg = TS.TrainConfig(**case["train"])
    state, opt = TS.init_sharded_train_state(
        params, tcfg, cfg, mesh, zero=case["zero"],
        offload_opt_state=case.get("offload_opt_state", False),
        offload_params=case.get("offload_params", False), min_size=0)
    step = TS.make_train_step(cfg, tcfg, opt, mesh=mesh)
    batches = np.load(case["batches"], allow_pickle=True)["batches"]
    metrics = []
    for b in batches:
        local = shard_batch(b, mesh, tcfg.grad_accum)
        state, m = step(state, runner.batch_to_device(local, "cpu"))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "grad_norm", "skipped_nonfinite")})
    out = {"metrics": metrics, "plans": [
        (p.name, p.mode, p.dp_dim, p.tp_dim) for p in opt.plans]}
    moments = TS.GatheredOptState(opt, mesh).sd
    with TS.whole_params(params, opt):
        if rank == 0:
            out["state"] = {k: v.clone() for k, v in
                            params.state_dict().items()}
            out["nu"] = moments["nu"]
            out["count"] = moments["count"]
    return out


def carry_inits(lora_path=None, switch_path=None):
    """Hand `run_training` the adapters / switch matrix saved at these
    paths (the JAX runner's initial ones) in place of its seeded init."""
    def lora(generator, cfg, lora_cfg, precision, device):
        adapters = TLora.LoraAdapters(cfg, lora_cfg, precision,
                                      device=device)
        adapters.load_state_dict(torch.load(lora_path))
        return adapters

    def switch(generator, hidden_size, precision, device):
        sw = TSw.Switch(hidden_size, precision, device=device)
        sw.load_state_dict(torch.load(switch_path))
        return sw
    if lora_path:
        runner.init_lora = lora
    if switch_path:
        runner.init_switch = switch


def run_runner(case, rank):
    """`run_training` on the case's RunConfig; returns its metrics log."""
    carry_inits(case.get("lora_init"), case.get("switch_init"))
    run = runner.run_training(RunConfig.from_dict(case["config"]),
                              device="cpu")
    out = {"steps": run.state["step"]}
    moments = TS.GatheredOptState(run.opt, run.mesh).sd
    if rank == 0:
        out["nu"] = moments["nu"]
        out["count"] = moments["count"]
    return out


def _part(x, mesh, axis, dim=1):
    """This rank's shard of x along `dim` over the mesh axis."""
    n, c = mesh.n(axis), mesh.coord(axis)
    sl = x.shape[dim] // n
    return x.narrow(dim, c * sl, sl)


def run_ring(case, rank):
    """`ring_attention` over a seq group of 4, causal, both routes: this
    rank's output shard and the q / k / v gradient shards of
    sum(out * dO) (dO zero at pad rows for the flash route, which takes no
    key mask)."""
    mesh = make_mesh(n_data=1, n_seq=4)
    d = {k: torch.from_numpy(v) for k, v in np.load(case["inputs"]).items()}
    mask = _part(d["mask"], mesh, "seq")
    out = {}
    for flash in (False, True):
        q, k, v = (_part(d[n], mesh, "seq").clone().requires_grad_()
                   for n in "qkv")
        do = _part(d["do"], mesh, "seq")
        if flash:
            do = do * mask[:, :, None, None]
        (o,) = TR.ring_attention([q], [k], [v],
                                 ring=TR.GroupRing(mesh.group("seq")),
                                 causal=True, kv_masks=[mask], flash=flash)
        grads = torch.autograd.grad(o, (q, k, v), do)
        out["flash" if flash else "plain"] = [o.detach(), *grads]
    return out


def run_cp_decoder(case, rank):
    """The decoder over (data 2, seq 2) with `cp`: this rank's hidden
    shard; the loss and the decoder gradients summed over the ranks."""
    mesh = make_mesh(n_data=2, n_seq=2)
    cfg = TL.tiny()
    dec = TL.LlamaModel(cfg, FP32_PRECISION)
    dec.load_state_dict(torch.load(case["init"]))
    dec.requires_grad_(True)
    d = {k: torch.from_numpy(v) for k, v in np.load(case["inputs"]).items()}
    rows = torch.from_numpy(data_rows(d["embeds"].shape[0], mesh))
    embeds, positions, mask, labels = (d[k][rows] for k in (
        "embeds", "positions", "mask", "labels"))
    targets = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                        -100)], 1)
    count = comm.all_reduce(TL.valid_targets(
        targets, cfg.vocab_size).sum(), mesh.group("data"))
    h, _ = dec(_part(embeds, mesh, "seq"), _part(positions, mesh, "seq"),
               attn_mask=_part(mask, mesh, "seq"),
               cp=TR.ContextParallel(mesh))
    nll, _ = TL.target_nll(TL.logits_fn(dec, h), _part(targets, mesh, "seq"))
    loss = nll / count
    names, leaves = zip(*dec.named_parameters())
    # the embedding takes no gradient here (the embeddings are given)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    total = loss.detach().clone()
    for g in (mesh.group("data"), mesh.group("seq")):
        comm.all_reduce(total, g)
        for x in grads:
            comm.all_reduce(x, g)
    return {"hidden": h.detach(), "rows": rows, "coord": mesh.coord("seq"),
            "loss": float(total), "grads": dict(zip(names, grads))}


def main(job_path, rank):
    with open(job_path) as f:
        job = json.load(f)
    preprocess.SimpleTokenizer.encode = crc_encode
    store = dist.FileStore(job["store"], job["world"])
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=job["world"])
    try:
        for case in job["cases"]:
            fn = {"runner": run_runner, "steps": run_steps,
                  "ring": run_ring, "cp_decoder": run_cp_decoder}[
                      case["kind"]]
            result = fn(case, rank)
            torch.save(result, os.path.join(
                job["out"], f"{case['name']}.rank{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
