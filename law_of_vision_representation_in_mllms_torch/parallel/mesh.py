"""Process mesh and multi-process start (counterpart of the JAX package's
`parallel/mesh.py`).

The JAX package lays its devices out as one `jax.sharding.Mesh` and lets
GSPMD insert every collective. Here each process drives one card
(`cuda:LOCAL_RANK`) and a `Mesh` names where this process sits on the axes

- ``data``  — batch rows (data parallelism; ZeRO-2/3 shard the optimizer
  state and the parameters over it, `parallel/fsdp.py`),
- ``model`` — Megatron tensor parallelism of the LLaMA decoder
  (`models/llama.py`),
- ``stage`` — pipeline parallelism: a stage's decoder layers and the GPipe
  hand-off between neighbours (`parallel/pipeline.py`),
- ``seq`` — context parallelism: the sequence's shards and the ring of
  K / V blocks (`ops/ring_attention.py`),

with one `torch.distributed` process group a line of each axis (a line of
one process too, so that a one-card run with a process group runs every
collective). The ranks
are laid out row-major over the axes in the JAX order (``data`` outermost,
``model`` innermost), so rank r holds the device that `make_mesh` puts at
`np.unravel_index(r, shape)` in the JAX mesh. The collectives run over NCCL
on the card and over gloo only when the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """`shape`: axis -> size, in mesh order; `rank`: this process's rank in
    the world; `groups`: axis -> the process group of this rank's line along
    that axis (none without a process group, or for a plan)."""
    shape: Dict[str, int]
    rank: int = 0
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return int(idx[list(self.shape).index(axis)])

    def group(self, axis: str):
        return self.groups.get(axis)

    def n(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def world() -> tuple:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
              n_stage: int = 1, *, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A (data[, stage][, seq], model) mesh over the world's processes; the
    optional axes appear only when their size is > 1 (the JAX axis order
    and `n_data=None` rule: the processes left after the other axes).

    With a process group the groups of every axis line are built (every
    rank builds all of them, in one order, as `new_group` requires).
    `world_size` / `rank` make a plan for a world that need not exist: the
    same checks and coordinates, no groups."""
    plan = world_size is not None
    r0, w0 = world()
    n_world = world_size if plan else w0
    rank = (rank or 0) if plan else r0
    if n_data is None:
        n_data = n_world // (n_model * n_seq * n_stage)
    dims = [("data", n_data), ("stage", n_stage), ("seq", n_seq),
            ("model", n_model)]
    dims = [(name, n) for name, n in dims
            if n > 1 or name in ("data", "model")]
    total = math.prod(n for _, n in dims)
    label = "x".join(str(n) for _, n in dims)
    if total > n_world:
        raise ValueError(f"mesh {label} > {n_world} devices")
    if total < n_world:
        # a JAX program may leave devices idle; a process outside the mesh
        # would run the whole job on its own
        raise ValueError(f"mesh {label} < {n_world} processes: every "
                         f"process needs a place in the mesh")
    mesh = Mesh(shape=dict(dims), rank=rank)
    if plan or not dist.is_initialized():
        return mesh
    ranks = np.arange(total).reshape([n for _, n in dims])
    for i, (name, n) in enumerate(dims):
        for line in np.moveaxis(ranks, i, -1).reshape(-1, n):
            group = dist.new_group([int(x) for x in line])
            if rank in line:
                mesh.groups[name] = group
    return mesh


def local_device() -> torch.device:
    """The card this process drives: `cuda:LOCAL_RANK` (torchrun's, else 0)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: str = "cuda") -> bool:
    """Start the process group: the reference's
    `dist.init_process_group("nccl")` (`extract.py:254`) / deepspeed
    launcher step, and the JAX `init_distributed`.

    The coordinator, world size and rank come from the arguments, else from
    `LVR_COORDINATOR` (host:port), `LVR_NUM_PROCESSES` and `LVR_PROCESS_ID`,
    else from torchrun's `RANK` / `WORLD_SIZE` (and `MASTER_ADDR` /
    `MASTER_PORT`). NCCL on the card (`cuda:LOCAL_RANK` becomes the current
    device), gloo when `device="cpu"`. Returns False only when a group
    already exists; a missing coordinator or a failed start raises, because
    falling back to one process would have every process run the whole job
    on its own (and write the same output files)."""
    if dist.is_initialized():
        return False
    env = os.environ
    coordinator_address = coordinator_address or env.get("LVR_COORDINATOR")
    if num_processes is None and env.get("LVR_NUM_PROCESSES"):
        num_processes = int(env["LVR_NUM_PROCESSES"])
    if process_id is None and env.get("LVR_PROCESS_ID"):
        process_id = int(env["LVR_PROCESS_ID"])
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the number of processes "
                             "and this process's id (LVR_NUM_PROCESSES, "
                             "LVR_PROCESS_ID)")
        init = f"tcp://{coordinator_address}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        init = "env://"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    else:
        raise ValueError("no coordinator: set LVR_COORDINATOR, "
                         "LVR_NUM_PROCESSES and LVR_PROCESS_ID, or start "
                         "the processes with torchrun")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def process_shard(items, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Rank-slice a document list (the eval harness's data parallelism; the
    reference's `DistributedSampler`, `llava/feature/extract.py:213`)."""
    r, w = world()
    i = r if process_index is None else process_index
    n = w if process_count is None else process_count
    return items[i::n]


def data_rows(n_rows: int, mesh: Mesh, grad_accum: int = 1) -> np.ndarray:
    """The global batch rows this data rank holds: the JAX `shard_batch`
    split of the leading axis. With `grad_accum` a > 1 the batch is a
    microbatches of n_rows / a rows (the JAX reshape [a, B / a, ...]), each
    split over the data axis; the rank's rows are its share of microbatch 0,
    then of microbatch 1, ..., so that cutting them into a consecutive
    parts gives its share of each microbatch."""
    n = mesh.n("data")
    a = max(1, grad_accum)
    if n_rows % (a * n):
        raise ValueError(f"batch of {n_rows} rows must divide over "
                         f"{a} microbatches x the data axis ({n} ways)")
    per = n_rows // (a * n)
    d = mesh.coord("data")
    return np.concatenate([np.arange(i * n_rows // a + d * per,
                                     i * n_rows // a + (d + 1) * per)
                           for i in range(a)])


def shard_batch(batch: Dict, mesh: Mesh, grad_accum: int = 1) -> Dict:
    """This data rank's rows (`data_rows`) of a `collate_batch` dict (numpy
    arrays, `pixel_values` a list per tower)."""
    rows = data_rows(len(batch["input_ids"]), mesh, grad_accum)
    return {k: ([x[rows] for x in v] if isinstance(v, list) else v[rows])
            for k, v in batch.items()}
