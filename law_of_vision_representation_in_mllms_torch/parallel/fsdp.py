"""ZeRO placement: parameters and optimizer state sharded on the data axis
(counterpart of the JAX package's `parallel/fsdp.py`).

The reference trains with deepspeed ZeRO-2 (`scripts/zero2.json:16-23`:
optimizer-state and gradient partitioning), ships ZeRO-3 configs
(`scripts/zero3.json:16-28`: parameter partitioning) and a CPU-offload one
(`scripts/zero3_offload.json`). The JAX package gets them as placements
that GSPMD turns into collectives; torch has no GSPMD, so the placement
here is carried out by hand over `parallel/comm.py`:

- ``zero=0``  tensor parallelism only; gradients all-reduced over data;
- ``zero=2``  parameters stay whole on every data rank; each rank keeps the
  AdamW moments of its slice of each leaf along the dim `fsdp_spec` picks;
  gradients are reduce-scattered, the update runs on the slice and the
  parameter is all-gathered again (`train/train_step.py`);
- ``zero=3``  the parameters are held sliced too (`shard_parameters`): a
  leaf is all-gathered where it is used (`comm.gather_shard`, a
  parametrization, so each use gathers it and the gathered copy lives only
  as long as the autograd graph or the remat of its block needs it) and its
  gradient reduce-scattered onto the slice.

The spec functions (`fsdp_spec`, `derived_state_specs`, `memory_report`)
give the JAX functions' answers on the same shapes; a spec is a tuple of
per-dim axis names (`P`). The port's decoder holds one module a block, so
its leaves are the JAX stacked leaves without the layer axis, and
`fsdp_spec` may pick another dim for them (or none, under
`MIN_SIZE_TO_SHARD`): the placement differs, the numbers do not.

Host offload (`ParamOffload`, and `train_step.FusedAdamW(offload=True)` for
the moments) keeps tensors in pinned host memory between steps, page-locked
by `cudaHostRegister` in exact-size chunks (`HostBlock`).
"""

from __future__ import annotations

import math
import mmap
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from . import comm

# Leaves smaller than this many elements stay replicated (the JAX value):
# sharding tiny norm vectors buys nothing and costs a collective each.
MIN_SIZE_TO_SHARD = 1 << 16
# leaves of at least this many elements go to the host under an offload
# (the JAX `offload_shardings` threshold)
MIN_SIZE_TO_OFFLOAD = 1 << 12


class P(tuple):
    """A partition spec: one entry a dim, None (replicated), an axis name,
    or a tuple of axis names."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _spec_axes(spec) -> List[tuple]:
    out = []
    for dim in spec:
        if dim is None:
            out.append(())
        elif isinstance(dim, (tuple, list)):
            out.append(tuple(dim))
        else:
            out.append((dim,))
    return out


def fsdp_spec(shape, base: Optional[tuple], n_shard: int, *,
              axis: str = "data", min_size: int = MIN_SIZE_TO_SHARD) -> P:
    """Add `axis` to the largest dim of `shape` not already sharded by
    `base` and divisible by n_shard. Idempotent: if `base` already uses
    `axis`, returns `base` unchanged."""
    base = P(*base) if base is not None else P(*([None] * len(shape)))
    dims = _spec_axes(base) + [()] * (len(shape) - len(base))
    if any(axis in d for d in dims):
        return base
    if n_shard <= 1 or math.prod(shape) < min_size:
        return base
    candidates = [i for i, d in enumerate(shape)
                  if not dims[i] and d % n_shard == 0]
    if not candidates:
        return base
    best = max(candidates, key=lambda i: shape[i])
    new_dims = [(tuple(d) if len(d) != 1 else d[0]) if d else None
                for d in dims]
    new_dims[best] = axis
    return P(*new_dims)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list)) and not (
        isinstance(x, tuple) and not isinstance(x, P))


def tree_map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a tree of dicts, lists and tuples (a `P` is a
    leaf; an empty tuple, like optax's `MaskedNode`, has no leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if not _is_leaf(tree):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(path, tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map_with_path(lambda _, x: out.append(x), tree)
    return out


def _try_walk(tree, path) -> Optional[P]:
    node = tree
    for k in path:
        if isinstance(node, P):
            return None
        if isinstance(node, dict) and k in node:
            node = node[k]
        elif isinstance(node, (list, tuple)) and isinstance(k, int) \
                and k < len(node):
            node = node[k]
        else:
            return None
    return node if isinstance(node, P) else None


def derived_state_specs(state_shapes, param_specs, mesh, *,
                        shard_derived: bool = True, axis: str = "data",
                        min_size: int = MIN_SIZE_TO_SHARD):
    """Spec tree for a state whose leaves mirror parameter subtrees (the
    AdamW moments): each leaf takes the spec of the longest path suffix that
    lands on a spec in `param_specs`; unmatched leaves replicate; with
    `shard_derived`, matched leaves also get the data-axis dim (how zero=2
    shards the moments of whole parameters)."""
    n = mesh.shape[axis]

    def choose(path, leaf):
        spec = None
        for i in range(len(path)):
            spec = _try_walk(param_specs, path[i:])
            if spec is not None:
                break
        shape = tuple(np.shape(leaf)) if not hasattr(leaf, "shape") \
            else tuple(leaf.shape)
        if spec is None or len(spec) > len(shape):
            spec = None if len(shape) else P()
        if spec is None:
            spec = P(*([None] * len(shape)))
        if shard_derived and len(shape):
            spec = fsdp_spec(shape, spec, n, axis=axis, min_size=min_size)
        return spec

    return tree_map_with_path(choose, state_shapes)


def _itemsize(dtype) -> int:
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _leaf_bytes(leaf) -> int:
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
    size = math.prod(shape) if shape else 1
    return size * _itemsize(getattr(leaf, "dtype", None))


def _shard_factor(spec, mesh) -> int:
    f = 1
    for axes in _spec_axes(spec):
        for a in axes:
            f *= mesh.shape[a]
    return f


def memory_report(tree, specs, mesh) -> Dict[str, Any]:
    """Bytes a rank for a (state, spec) pair; `tree` may hold tensors or
    anything with `.shape` / `.dtype`: nothing is allocated."""
    leaves = tree_leaves(tree)
    spec_leaves = tree_leaves(specs)
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    total = per_chip = unsharded = 0
    for leaf, spec in zip(leaves, spec_leaves):
        b = _leaf_bytes(leaf)
        total += b
        per_chip += -(-b // _shard_factor(spec, mesh))
        if _shard_factor(spec, mesh) == 1 and b >= 1 << 20:
            unsharded += b
    return {
        "total_bytes": total,
        "per_chip_bytes": per_chip,
        "per_chip_gb": per_chip / (1 << 30),
        "replicated_large_bytes": unsharded,
        "n_devices": mesh.size,
    }


def spec_dim(spec, axis: str) -> Optional[int]:
    """The dim of `spec` that `axis` shards, or None."""
    for i, axes in enumerate(_spec_axes(spec)):
        if axis in axes:
            return i
    return None


# ---------------------------------------------------------------------------
# ZeRO-3: parameters held as slices, gathered where they are used
# ---------------------------------------------------------------------------

class _Gathered(nn.Module):
    """The parametrization of a ZeRO-3 leaf: the held slice -> the whole
    leaf (all-gather over the data group; reduce-scatter of its
    gradient)."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim = dim
        self.group = group

    def forward(self, shard):
        return comm.gather_shard(shard, self.dim, self.group)


def _owner(root: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, leaf = name.split(".")
    module = root
    for p in path:
        module = getattr(module, p)
    return module, leaf


def shard_parameters(root: nn.Module, dims: Dict[str, int], group) -> None:
    """Hold each named parameter of `dims` (name -> data dim) as this rank's
    slice along that dim; every read of the attribute all-gathers it. The
    Parameter objects (and their `requires_grad`) stay the same."""
    for name, dim in dims.items():
        module, leaf = _owner(root, name)
        p = getattr(module, leaf)
        with torch.no_grad():
            p.data = comm.local_slice(p.data, dim, group).clone()
        parametrize.register_parametrization(module, leaf,
                                             _Gathered(dim, group),
                                             unsafe=True)


def unshard_parameters(root: nn.Module) -> list:
    """Undo `shard_parameters` in place (every rank gathers every leaf):
    each attribute is a whole Parameter again. Returns what
    `reshard_parameters` needs."""
    held = []
    for module in list(root.modules()):
        if not parametrize.is_parametrized(module):
            continue
        for leaf in list(module.parametrizations.keys()):
            plist = module.parametrizations[leaf]
            shard, gather = plist.original, plist[0]
            with torch.no_grad():
                whole = getattr(module, leaf).detach().clone()
            parametrize.remove_parametrizations(module, leaf,
                                                leave_parametrized=False)
            full = nn.Parameter(whole, requires_grad=shard.requires_grad)
            setattr(module, leaf, full)
            held.append((module, leaf, shard, gather))
    return held


def reshard_parameters(held) -> None:
    """Put back what `unshard_parameters` undid: the same slice Parameters
    (with the whole tensors' values, which may have been loaded meanwhile)
    under the same parametrizations."""
    for module, leaf, shard, gather in held:
        whole = getattr(module, leaf)
        with torch.no_grad():
            shard.data = comm.local_slice(whole.data, gather.dim,
                                          gather.group).clone()
        delattr(module, leaf)
        module.register_parameter(leaf, shard)
        parametrize.register_parametrization(module, leaf, gather,
                                             unsafe=True)


# ---------------------------------------------------------------------------
# host offload
# ---------------------------------------------------------------------------

# host blocks are mapped and pinned in chunks of this many bytes, several at
# once, their pages populated with the mapping: tens of GB pinned as one
# mapping, or faulted in page by page, took several times longer
HOST_CHUNK_BYTES = 1 << 30
_ALIGN = 256


def _host_chunk(nbytes: int, pin: bool) -> torch.Tensor:
    """`nbytes` zero bytes in an anonymous mapping of their own, its pages
    populated at once (the kernel hands out zeroed pages: no memset), and
    page-locked by `cudaHostRegister` at their exact size when `pin` (the
    caching host allocator would round a block up to a power of two). A
    failed registration raises."""
    region = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                       | getattr(mmap, "MAP_POPULATE", 0))
    with warnings.catch_warnings():
        # torch warns on buffers it cannot prove writable; the mapping is
        warnings.simplefilter("ignore", UserWarning)
        chunk = torch.frombuffer(region, dtype=torch.uint8, count=nbytes)
    if pin:
        err = torch.cuda.cudart().cudaHostRegister(chunk.data_ptr(), nbytes,
                                                   0)
        if int(getattr(err, "value", err)) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes / 1e9:.2f} GB "
                               f"failed: error {err}")
    return chunk


def _unpin(chunks: List[torch.Tensor], device: torch.device) -> None:
    """Wait for every copy queued on the card (from or to the chunks), then
    unregister the chunks: CUDA wants pinned memory unregistered before it
    is unmapped, and the chunks are unmapped once nothing holds them."""
    torch.cuda.synchronize(device)
    for c in chunks:
        torch.cuda.cudart().cudaHostUnregister(c.data_ptr())


class HostBlock:
    """Zero-filled host tensors of the given (shape, dtype)s, packed in
    order into chunks of up to HOST_CHUNK_BYTES (a larger tensor gets a
    chunk of its own), which are mapped, populated and, for a card
    (`device` of type cuda), page-locked several at once. For the CPU they
    are plain host memory: nothing to pin for.

    Pinned chunks are unregistered by `release` or, failing that, when the
    block is collected (a finaliser that holds the chunks until then), so
    no mapping is freed while it is registered. Tensors of the block that
    outlive it stay valid host memory, no longer page-locked."""

    def __init__(self, shapes: Iterable[Tuple[tuple, torch.dtype]],
                 device: torch.device):
        self.pinned = torch.device(device).type == "cuda"
        sizes, places = [], []
        for shape, dtype in shapes:
            nb = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            if not sizes or sizes[-1] + nb > HOST_CHUNK_BYTES:
                sizes.append(0)
            places.append((len(sizes) - 1, sizes[-1], nb, shape, dtype))
            sizes[-1] += -(-nb // _ALIGN) * _ALIGN
        with ThreadPoolExecutor(max(1, min(8, len(sizes)))) as pool:
            self.chunks = list(pool.map(
                lambda nb: _host_chunk(max(nb, 1), self.pinned), sizes))
        self.tensors = [self.chunks[c][o:o + nb].view(dtype).view(shape)
                        for c, o, nb, shape, dtype in places]
        self._unpin = weakref.finalize(self, _unpin, self.chunks,
                                       torch.device(device)) \
            if self.pinned else None

    @property
    def nbytes(self) -> int:
        return sum(c.numel() for c in self.chunks)

    def release(self) -> None:
        """Unregister the chunks once the card's queued copies are done
        (before they are freed) and drop them."""
        if self._unpin is not None:
            self._unpin()
        self.chunks, self.tensors = [], []


class ParamOffload:
    """`offload_params` (deepspeed offload_param, the JAX
    `params_to_host`): the module's parameters and buffers of at least
    MIN_SIZE_TO_OFFLOAD elements live in pinned host memory between steps
    (`to_host`) and on the device for a step (`to_device`). The tensor
    objects stay the same; their `.data` moves. After a step only what
    trains is copied back (`trained_only`): a frozen leaf's host copy still
    holds its values, so its device copy is dropped."""

    def __init__(self, root: nn.Module, device: torch.device):
        self.device = torch.device(device)
        self.held, self.host = [], None
        if self.device.type != "cuda":
            return          # a CPU run's parameters are host memory already
        seen = set()
        for t in list(root.parameters()) + list(root.buffers()):
            if id(t) in seen or t.numel() < MIN_SIZE_TO_OFFLOAD:
                continue
            seen.add(id(t))
            self.held.append(t)
        self.host = HostBlock(((tuple(t.shape), t.dtype) for t in self.held),
                              self.device)
        self.to_host()

    def to_device(self) -> None:
        if self.device.type != "cuda":
            return
        for t, h in zip(self.held, self.host.tensors):
            if t.data.data_ptr() == h.data_ptr():
                t.data = h.to(self.device, non_blocking=True)

    def to_host(self, trained_only: bool = False) -> None:
        """Every held tensor back to its host copy; with `trained_only`
        only the parameters that require a gradient are copied there (the
        others have not changed since `to_device`)."""
        if self.device.type != "cuda":
            return
        for t, h in zip(self.held, self.host.tensors):
            if t.data.data_ptr() != h.data_ptr() and (
                    t.requires_grad or not trained_only):
                h.copy_(t.data, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        for t, h in zip(self.held, self.host.tensors):
            t.data = h

    def release(self) -> None:
        """The parameters back on the device for good; the host block
        unpinned."""
        if self.host is not None:
            self.to_device()
            self.host.release()
            self.host = None
