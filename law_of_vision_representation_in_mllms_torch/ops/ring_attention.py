"""Ring attention: context parallelism over the mesh's ``seq`` axis
(counterpart of the JAX package's `ops/ring_attention.py`).

The sequence is cut into n shards, one a rank of the ring; each rank keeps
its query block and the key / value blocks travel around the ring, so no
rank holds the whole K / V or an [S, S] score matrix. K / V rotate at their
true kv-head count (grouped-query attention: query head h reads kv head
h // (H / KV)). The ring runs on whatever heads and batch rows a rank holds,
so tensor and data parallelism need nothing of it.

A ring names the ranks its process runs (`ranks`) and how blocks move
between them (`shift`): `GroupRing`, point to point over a process group
(`parallel.comm.ring_shift`, one rank a process; what
`ContextParallel.ring` gives the decoder), or `LocalRing`, every rank of
the ring in one process, a shift handing each rank the references of the
rank before (no copy). Both routes take one shard a rank the process runs
and return one output each.

Two routes:

- **plain** (`ring_attention_plain`): the JAX `ring_attention` formula, an
  fp32 online softmax over the rotating blocks, with the [B, S_local] key
  mask rotating with its block and causality from global positions (array
  order). Differentiable by autograd; a group's shift sends the gradients
  the other way round. The CPU and fp32 compute take it, as the decoder's
  plain masked attention;
- **flash** (`RingFlashAttention`, CUDA with bf16 compute): the block from
  source ``src = (rank - step) mod n`` runs kernel 2 with its LSE
  (`flash_block_forward`): causal on the diagonal (``src == rank``),
  non-causal below it (``src < rank``), not at all above it. The partial
  outputs merge in fp32 by their LSEs (`merge_blocks`). The backward runs
  kernel 5, then kernel 6 on each block (`flash_block_backward`) with the
  MERGED LSE and output, so kernel 5's δ = rowsum(dO·O) is the global one;
  dq accumulates in fp32 on its rank, the fp32 dk / dv accumulators travel
  the ring with their blocks and are home after n hops. Every rank issues
  the same shifts at every step, also at the steps at which it skips a
  block.

Padding contract of the flash route (that of `ops/flash_attention.py`): no
key mask reaches the kernels. The spliced batch is right-padded, so under
causality a valid query never sees a pad key; only pad rows (whose labels
are ignored) differ from the plain route. For a CPU tensor each block
function runs its kernel's plain version; for a CUDA tensor it launches the
kernel or raises: nothing here gives way to the plain ring or to SDPA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..parallel import comm
from .flash_attention import flash_attention, flash_attention_bwd

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ContextParallel:
    """Ring attention's place in a model's `parallel.Mesh`: the ring is a
    line of the mesh's ``seq`` axis."""
    mesh: object

    @property
    def group(self):
        return self.mesh.group("seq")

    @property
    def n_seq(self) -> int:
        return self.mesh.n("seq")

    @property
    def coord(self) -> int:
        return self.mesh.coord("seq")

    @property
    def ring(self) -> "GroupRing":
        return GroupRing(self.group)


class _Shift(torch.autograd.Function):
    """`comm.ring_shift` by `shift` places; the gradients of the floating
    tensors go back the other way (a key mask takes none)."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        ctx.fp = [x.is_floating_point() for x in xs]
        ys = comm.ring_shift(list(xs), group, shift=shift)
        ctx.mark_non_differentiable(*(y for y, fp in zip(ys, ctx.fp)
                                      if not fp))
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        back = iter(comm.ring_shift(
            [g.contiguous() for g, fp in zip(gs, ctx.fp) if fp], ctx.group,
            shift=-ctx.shift))
        return (None, None, *(next(back) if fp else None for fp in ctx.fp))


class GroupRing:
    """This process is one rank of the group's ring; a shift is point to
    point (`comm.ring_shift`, differentiable). The identity without a
    group."""

    def __init__(self, group):
        self.group = group
        self.n = comm.size(group)
        self.ranks = (comm.rank(group),)

    def shift(self, held, shift: int = 1):
        """`held`: a list of tensors a rank here (one). Returns what each
        receives: the list of the rank `shift` places before it."""
        (xs,) = held
        return [list(_Shift.apply(self.group, shift, *xs))]


class LocalRing:
    """Every rank of a ring of n in this process: a shift hands each rank
    the tensors of the rank `shift` places before it, as they are."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = tuple(range(n))

    def shift(self, held, shift: int = 1):
        return [list(held[(r - shift) % self.n]) for r in self.ranks]


# ---------------------------------------------------------------------------
# the plain route: the JAX formula
# ---------------------------------------------------------------------------

def plain_init(q, nkv: int):
    """The running (m, l, acc) of the online softmax for the local q
    [B, Sl, H, D]: [B, KV, G, Sl, 1] twice and [B, KV, G, Sl, D], fp32."""
    b, sl, nh, d = q.shape
    shape = (b, nkv, nh // nkv, sl)
    m = torch.full(shape + (1,), NEG_INF, dtype=torch.float32,
                   device=q.device)
    return m, torch.zeros_like(m), torch.zeros(shape + (d,),
                                               dtype=torch.float32,
                                               device=q.device)


def plain_scaled_q(q, nkv: int, scale: Optional[float] = None):
    """q in fp32 times the softmax scale, as [B, Sl, KV, G, D]."""
    b, sl, nh, d = q.shape
    if scale is None:
        scale = d ** -0.5
    return (q.float() * scale).reshape(b, sl, nkv, nh // nkv, d)


def plain_step(state, qf, k, v, kv_mask, q_pos, k_pos, causal: bool):
    """One step of the JAX ring: the block (k, v [B, Sk, KV, D], kv_mask
    [B, Sk] bool) at global key positions k_pos [Sk] folded into the
    running state for the queries qf (`plain_scaled_q`) at q_pos [Sq]."""
    m, l, acc = state
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    valid = kv_mask.bool()[:, None, None, None, :]
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])[None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m_new, l_new, acc_new


def plain_finish(state, q):
    """The local output [B, Sl, H, D] in q's dtype."""
    _, l, acc = state
    b, nkv, g, sl, d = acc.shape
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sl, nkv * g, d).to(q.dtype)


def ring_attention_plain(qs, ks, vs, *, ring, causal: bool = True,
                         kv_masks=None, scale: Optional[float] = None):
    """The plain ring. qs: the shard [B, Sl, H, D] of each rank of
    `ring.ranks`; ks, vs [B, Sl, KV, D]; kv_masks: optional [B, Sl] bool
    key validity (False: attended by nobody). Returns the outputs
    [B, Sl, H, D]."""
    b, sl, _, _ = qs[0].shape
    nkv = ks[0].shape[2]
    if kv_masks is None:
        kv_masks = [torch.ones((b, sl), dtype=torch.bool, device=q.device)
                    for q in qs]
    qfs = [plain_scaled_q(q, nkv, scale) for q in qs]
    states = [plain_init(q, nkv) for q in qs]
    ar = torch.arange(sl, device=qs[0].device)
    held = [[k, v, m.bool()] for k, v, m in zip(ks, vs, kv_masks)]
    for step in range(ring.n):
        for j, rank in enumerate(ring.ranks):
            src = (rank - step) % ring.n
            states[j] = plain_step(states[j], qfs[j], *held[j],
                                   rank * sl + ar, src * sl + ar, causal)
        if step < ring.n - 1:
            held = ring.shift(held)
    return [plain_finish(st, q) for st, q in zip(states, qs)]


# ---------------------------------------------------------------------------
# the flash route: kernels 2, 5 and 6 a block
# ---------------------------------------------------------------------------

def block_launched(src: int, rank: int, causal: bool) -> bool:
    """Whether the block of source `src` runs on `rank` (above the diagonal
    a causal ring skips it)."""
    return src <= rank or not causal


def flash_block_forward(q, k, v, *, causal: bool):
    """Kernel 2 on one block: (out in q's dtype, fp32 LSE [B, H, Sq])."""
    with torch.no_grad():
        return flash_attention(q, k, v, causal=causal, return_lse=True)


def merge_blocks(out, lse, out_b, lse_b):
    """A running partial attention (out fp32 [B, Sq, H, D], lse fp32
    [B, H, Sq]; None before the first block) and a block's merged by their
    LSEs, in fp32. Returns the merged (out, lse), lse contiguous."""
    if out is None:
        return out_b.float(), lse_b.float().contiguous()
    new = torch.logaddexp(lse, lse_b)
    w = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - new).transpose(1, 2)[..., None]
    return out * w + out_b.float() * w_b, new.contiguous()


def flash_block_backward(q, k, v, out, lse, do, *, causal: bool):
    """Kernel 5 (forming δ from the merged out and dO), then kernel 6, on
    one block with the merged LSE: this block's (dq, dk, dv)."""
    return flash_attention_bwd(q, k, v, out, lse, do, causal=causal)


class RingFlashAttention(torch.autograd.Function):
    """The flash ring: `apply(ring, causal, q_0, k_0, v_0, q_1, ...)`, the
    shards [B, Sl, H | KV, D] (bf16 on the card) of each rank of
    `ring.ranks` in turn. Returns their outputs in q's dtype."""

    @staticmethod
    def forward(ctx, ring, causal: bool, *qkv):
        qs, n = qkv[0::3], ring.n
        outs, lses = [None] * len(qs), [None] * len(qs)
        held = [list(qkv[3 * j + 1:3 * j + 3]) for j in range(len(qs))]
        for step in range(n):
            for j, rank in enumerate(ring.ranks):
                src = (rank - step) % n
                if block_launched(src, rank, causal):
                    o_b, l_b = flash_block_forward(
                        qs[j], *held[j], causal=causal and src == rank)
                    outs[j], lses[j] = merge_blocks(outs[j], lses[j], o_b,
                                                    l_b)
            if step < n - 1:
                held = ring.shift(held)
        outs = [o.to(q.dtype) for o, q in zip(outs, qs)]
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.ring, ctx.causal = ring, causal
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        ring, causal = ctx.ring, ctx.causal
        n, h = ring.n, len(dos)
        saved = ctx.saved_tensors
        qkv, outs, lses = saved[:3 * h], saved[3 * h:4 * h], saved[4 * h:]
        qs = qkv[0::3]
        dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
               for q in qs]
        held = []
        for k, v in zip(qkv[1::3], qkv[2::3]):
            dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            held.append([k, v, dk, torch.zeros_like(dk)])
        for step in range(n):
            for j, rank in enumerate(ring.ranks):
                src = (rank - step) % n
                if block_launched(src, rank, causal):
                    k_cur, v_cur, dk, dv = held[j]
                    g_q, g_k, g_v = flash_block_backward(
                        qs[j], k_cur, v_cur, outs[j], lses[j],
                        dos[j].contiguous(), causal=causal and src == rank)
                    dqs[j].add_(g_q)
                    dk.add_(g_k)
                    dv.add_(g_v)
            # the accumulators travel with their blocks: K / V need n - 1
            # hops, dK / dV one more to reach home
            held = ring.shift(held if step < n - 1 else
                              [x[2:] for x in held])
        grads = []
        for j, (dk, dv) in enumerate(held):
            q, k, v = qkv[3 * j:3 * j + 3]
            grads += [dqs[j].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)]
        return (None, None, *grads)


def ring_attention(qs, ks, vs, *, ring, causal: bool = True, kv_masks=None,
                   flash: bool = False):
    """Ring attention over `ring` (`ContextParallel.ring`, `LocalRing`):
    qs, ks, vs (and kv_masks) one shard for each rank of `ring.ranks`;
    returns their outputs. The flash route (kernels 2, 5, 6; `kv_masks`
    unused, the padding contract) when `flash`, else the plain route."""
    if not len(qs) == len(ks) == len(vs) == len(ring.ranks):
        raise ValueError(f"{len(qs)} q, {len(ks)} k and {len(vs)} v shards "
                         f"for a ring that runs {len(ring.ranks)} ranks here")
    if flash:
        return list(RingFlashAttention.apply(
            ring, causal, *(t for qkv in zip(qs, ks, vs) for t in qkv)))
    return ring_attention_plain(qs, ks, vs, ring=ring, causal=causal,
                                kv_masks=kv_masks)
