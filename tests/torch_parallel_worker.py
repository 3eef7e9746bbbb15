"""One rank of a `gloo` world that runs the port's parallel training cases
for tests/test_torch_parallel_train.py:

    python tests/torch_parallel_worker.py JOB.json RANK

JOB.json names the world size, a `FileStore` path and the cases; each case
writes `<out>/<name>.rank<RANK>.pt`: every rank's per-step metrics, and on
rank 0 the whole trained state (gathered) and FusedAdamW's gathered second
moments. This module imports the port and torch only: the JAX references
are computed by the test process.
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
    llama as TL, llava as TM, lora as TLora, towers as TT, vit as TV)
from law_of_vision_representation_in_mllms_torch.ops import (  # noqa: E402
    quant as TQ)
from law_of_vision_representation_in_mllms_torch.parallel import (  # noqa: E402
    make_mesh, shard_batch)
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


def tiny_config():
    vit = TV.ViTConfig(image_size=14, patch_size=7, hidden_size=16,
                       num_layers=2, num_heads=2, intermediate_size=32)
    entry = TT.TowerEntry(name="tiny", kind="vit", vit_config=vit,
                          vit_family="clip", hidden_size=16,
                          num_patches=vit.num_patches)
    return TM.LlavaConfig(tower_spec=TT.TowerSpec(entries=[entry],
                                                  join="single"),
                          decoder=TL.tiny(**DECODER))


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
    return params.eval()


def run_steps(case, rank):
    """`make_train_step` over the case's global batches on its mesh."""
    cfg = tiny_config()
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


def run_runner(case, rank):
    """`run_training` on the case's RunConfig; returns its metrics log."""
    run = runner.run_training(RunConfig.from_dict(case["config"]),
                              device="cpu")
    out = {"steps": run.state["step"]}
    moments = TS.GatheredOptState(run.opt, run.mesh).sd
    if rank == 0:
        out["nu"] = moments["nu"]
        out["count"] = moments["count"]
    return out


def main(job_path, rank):
    with open(job_path) as f:
        job = json.load(f)
    preprocess.SimpleTokenizer.encode = crc_encode
    store = dist.FileStore(job["store"], job["world"])
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=job["world"])
    try:
        for case in job["cases"]:
            fn = run_runner if case["kind"] == "runner" else run_steps
            result = fn(case, rank)
            torch.save(result, os.path.join(
                job["out"], f"{case['name']}.rank{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
