"""Chunked greedy decoding and prompt-lookup speculation, replayed from CUDA
graphs (counterpart of the JAX package's `models/decode.py`).

The JAX `ChunkedGreedyDecoder` runs `chunk`-step `lax.scan`s under a host
loop that stops once every row is done. Here one chunk of `chunk` decode
steps (embed -> decoder forward at cache slot l_out + t -> logits -> argmax
-> eos latch) is captured once as a `torch.cuda.CUDAGraph` and replayed, so
the host issues one replay a chunk instead of every kernel of every layer
every token, and reads one flag back a chunk (`all_done`) instead of one a
token. Everything a chunk reads or writes lives in static tensors held per
key `(b, l, gen_cap)`: the cache of l_out + gen_cap slots, the current
token, the done flags, the RoPE positions, the prompt's validity, the step
counter `t0` as a device scalar and the tokens out. The step's slot and its
validity mask come from `t0` on the device (`arange(gen_cap) <= t`, as the
JAX chunk builds them), and the cache is written at a slot index held on the
device (`models/llama.py`), so nothing of a step is a host value.
`SpeculativeDecoder` keeps the verify round of `models.llava.
generate_speculative` the same way, a graph and static tensors a key.

A decoder keeps at most `max_keys` keys, the most recently used; an older
key's tensors and graph are freed. The graphs of a decoder share one memory
pool, which the eval adapter also hands its other decoder.

The prefill stays eager (kernels 1 and 2), into the key's static cache,
zeroed first, so a reused key gives a fresh one's bits. On the CPU the same
chunk (or round) runs eagerly, with no graph: that is what the tests hold
to the JAX decoder. On a CUDA device a failed capture or replay raises;
nothing falls back to eager launches.

Launch counters count where a wrapper launches its kernel, which under a
capture is the capture, not the replays: each graph keeps the launches of
the decode kernels recorded into it (`Replayable.launches`), and the
decoder its `captures` and `replays`, so that a caller can derive the
launches a run made: what the wrappers counted, less what the captures
recorded (`recorded`), plus what the replays launched (`graph_launches()`,
each replay adding its graph's recorded launches).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from ..ops import _build
from ..ops.decode_attention import decode_attention, decode_attention_int8
from ..ops.int4_matmul import int4_matmul_kernel
from . import llama as L
from . import llava as M
from .speculative import bigram_draft, pad_after_eos

# the kernels a decode step launches, whose launches a capture records
DECODE_KERNELS = {"decode_attention": decode_attention,
                  "decode_attention_int8": decode_attention_int8,
                  "int4_matmul": int4_matmul_kernel}


def _launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in DECODE_KERNELS.items()}


# one side stream a device for every warm-up and capture: cuBLAS keeps a
# workspace (32 MiB on the H100) for each stream it has run on, for the
# life of the process, so a stream a capture would leak one a key
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device) -> "torch.cuda.Stream":
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


class Replayable:
    """`fn()` reads and writes only tensors that outlive it. On a CUDA
    device it runs once eagerly on a side stream (the warm-up PyTorch's
    graph notes ask for; it changes the state as a call would) and is then
    captured as a CUDA graph, which every call replays; on the CPU every
    call runs `fn`. `launches` holds the decode kernels' launches recorded
    into the graph."""

    def __init__(self, fn: Callable[[], None], device, pool=None):
        self.fn = fn
        self.graph = None
        self.launches = {name: 0 for name in DECODE_KERNELS}
        if device.type != "cuda":
            return
        # a first-use nvcc build cannot happen inside a capture
        _build.library()
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        # thread_local: the server's HTTP threads may run CUDA-free work
        # while the worker thread captures
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            fn()
        after = _launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()


class _Keyed:
    """What a graph decoder keeps: per key, the static tensors and the graph
    of one shape, at most `max_keys` keys (the least recently used is
    dropped, its tensors and its graph freed: a key of LLaVA-1.5-7B holds
    its KV cache, 1.5 GB at B = 4, T = 735; two keep an eval's full batches
    and its tail batch), one graph pool for all its graphs (or the `pool`
    it is given), and the counts: `captures`, `replays` (graph replays,
    eager runs on the CPU), `recorded` (the decode kernels' launches the
    captures recorded: the wrappers counted them, but a capture launches
    nothing) and `graph_launches()` (the launches the replays made)."""

    max_keys = 2

    def __init__(self, pool):
        self._keys: "OrderedDict[tuple, object]" = OrderedDict()
        self._pool = pool
        self.captures = 0
        self.replays = 0
        self.recorded = {name: 0 for name in DECODE_KERNELS}
        self._replayed = {name: 0 for name in DECODE_KERNELS}

    def _lookup(self, key: tuple, make: Callable[[], object]):
        st = self._keys.pop(key, None)
        if st is None:
            while len(self._keys) >= self.max_keys:
                _, old = self._keys.popitem(last=False)
                old.step = None       # its graph held it through `fn`
            st = make()
        self._keys[key] = st          # the most recently used goes last
        return st

    def _capture(self, st, fn: Callable[[], None], device) -> bool:
        """Makes `st.step`; True when a graph was captured (whose warm-up
        call moved the state on)."""
        if device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        st.step = Replayable(fn, device, self._pool)
        if st.step.graph is None:
            return False
        self.captures += 1
        for name, n in st.step.launches.items():
            self.recorded[name] += n
        return True

    def _replay(self, st) -> None:
        st.step()
        self.replays += 1
        if st.step.graph is not None:
            for name, n in st.step.launches.items():
                self._replayed[name] += n

    def graph_launches(self) -> Dict[str, int]:
        """The decode kernels' launches made by the replays so far: each
        replay adds the launches its graph recorded."""
        return dict(self._replayed)


@dataclasses.dataclass
class _Static:
    """The tensors one key's chunk reads and writes."""
    cache: L.Cache
    tok: torch.Tensor          # [B] the token the next step feeds
    done: torch.Tensor         # [B] bool
    pos: torch.Tensor          # [B] its RoPE position
    prompt_valid: torch.Tensor  # [B, l_out] bool
    t0: torch.Tensor           # () the chunk's first generation step
    out: torch.Tensor          # [B, gen_cap] the tokens, by step
    all_done: torch.Tensor     # () bool, after a chunk
    l_out: int
    step: Optional[Replayable] = None


def _zeros(device):
    def zeros(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=device)
    return zeros


class ChunkedGreedyDecoder(_Keyed):
    """Greedy decode in `chunk`-step chunks with an early exit between
    chunks; the same `generate` contract as the JAX class. One instance
    keeps the static tensors and the graph of each key (batch, text length,
    gen_cap), at most `max_keys` of them; the eval adapter holds one a run.
    The prefill takes the flash route (kernel 2 on the card, its plain
    version on the CPU), and the params carry their precision.

    `negotiate_layouts` is the JAX package's XLA boundary-layout knob
    (`models/layouts.py`, not carried over): a PyTorch tensor has one
    layout, so it is accepted and ignored, as `core/config.py` does for the
    field."""

    def __init__(self, params: M.LlavaParams, cfg: M.LlavaConfig, *,
                 eos_id: int, chunk: int = 16,
                 negotiate_layouts: bool = False, pool=None):
        super().__init__(pool)
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.chunk = chunk

    def _make(self, b: int, l: int, gen_cap: int, device) -> _Static:
        l_out = l + self.cfg.num_patches - 1
        zeros = _zeros(device)
        return _Static(
            cache=L.init_cache(self.cfg.decoder, b, l_out + gen_cap,
                               self.params.decoder.precision.compute_dtype,
                               device, quant=self.cfg.kv_quant),
            tok=zeros(b), done=zeros(b, dtype=torch.bool), pos=zeros(b),
            prompt_valid=zeros(b, l_out, dtype=torch.bool), t0=zeros(),
            out=zeros(b, gen_cap), all_done=zeros(dtype=torch.bool),
            l_out=l_out)

    def _chunk(self, st: _Static) -> None:
        """`chunk` greedy steps from step t0: the body that is captured."""
        dec = self.params.decoder
        b, gen_cap = st.out.shape
        eos = self.eos_id
        gen_slots = torch.arange(gen_cap, device=st.out.device)
        for i in range(self.chunk):
            t = st.t0 + i
            valid = torch.cat([st.prompt_valid, (gen_slots <= t)[None].expand(
                b, gen_cap)], dim=1)
            h, _ = dec(L.embed_tokens(dec, st.tok[:, None]), st.pos[:, None],
                       attn_mask=valid, cache=st.cache,
                       cache_index=(st.l_out + t).expand(b))
            nxt = L.logits_fn(dec, h)[:, -1].argmax(dim=-1)
            st.out.index_copy_(1, t.reshape(1), st.tok[:, None])
            st.done |= st.tok == eos
            st.tok.copy_(nxt.masked_fill(st.done, eos))
            st.pos.add_(1)
        st.t0.add_(self.chunk)
        st.all_done.copy_((st.done | (st.tok == eos)).all())

    def _load(self, st: _Static, pre: M.Prefill) -> None:
        st.tok.copy_(pre.logits.argmax(dim=-1))
        st.done.zero_()
        st.pos.copy_(pre.n_valid)
        st.prompt_valid.copy_(pre.slot_valid[:, :st.l_out])
        st.t0.zero_()

    def _start(self, input_ids, text_mask, pixel_values,
               gen_cap: int) -> _Static:
        """The key's static tensors, the prefill run into its cache and the
        chunk captured if it was not: ready for the first chunk."""
        b, l = input_ids.shape
        device = input_ids.device
        st = self._lookup((b, l, gen_cap),
                          lambda: self._make(b, l, gen_cap, device))
        pre = M.prefill(self.params, self.cfg, input_ids, text_mask,
                        pixel_values, max_new_tokens=gen_cap, cache=st.cache)
        self._load(st, pre)
        if st.step is None and self._capture(st, lambda: self._chunk(st),
                                             device):
            self._load(st, pre)           # the warm-up chunk moved them on
        return st

    def _decode(self, st: _Static, n_chunks: int) -> int:
        """Runs up to `n_chunks` chunks, stopping once every row is done;
        returns the chunks run."""
        for c in range(n_chunks):
            self._replay(st)
            if bool(st.all_done):          # one host read a chunk
                break
        return c + 1

    @torch.inference_mode()
    def generate(self, input_ids, text_mask, pixel_values, *,
                 max_new_tokens: int) -> torch.Tensor:
        """Returns [B, max_new_tokens] token ids, eos-padded: the contract
        of `models.llava.generate_greedy`."""
        n_chunks = -(-max_new_tokens // self.chunk)
        st = self._start(input_ids, text_mask, pixel_values,
                         n_chunks * self.chunk)
        ran = self._decode(st, n_chunks)
        b = input_ids.shape[0]
        out = torch.full((b, max_new_tokens), self.eos_id, dtype=torch.long,
                         device=input_ids.device)
        n = min(ran * self.chunk, max_new_tokens)
        out[:, :n] = st.out[:, :n]
        return out


@dataclasses.dataclass
class _SpecStatic:
    """The tensors one key's verify round reads and writes."""
    cache: L.Cache
    hist: torch.Tensor          # [B, L + gen_cap] the token history
    n_gen: torch.Tensor         # () tokens generated so far
    rounds: torch.Tensor        # () verify rounds run
    prompt_valid: torch.Tensor  # [B, l_out] bool
    n_valid: torch.Tensor       # [B] valid prompt length
    l_out: int
    step: Optional[Replayable] = None


class SpeculativeDecoder(_Keyed):
    """Greedy-equivalent decode with prompt-lookup speculation (`models/
    speculative.py`) on the full LLaVA path: right-padded ragged batches
    (positions per row, cache slots shared, acceptance the minimum over
    rows). `generate` returns ([B, max_new_tokens] tokens, the number of
    verification rounds), as `models.llava.generate_speculative` does.

    A round is a verify forward of draft_len + 1 tokens at slots held on
    the device (the plain masked attention: the query is longer than one),
    the accepted count, and the history's update, all on the key's static
    tensors (key: batch, text length, max_new_tokens). On the card the
    round is captured once a key as a CUDA graph and replayed, and the host
    reads the generated count back once a round (the JAX `while_loop` reads
    it on the device); on the CPU it runs eagerly. Keys, pool and counts as
    `ChunkedGreedyDecoder`'s."""

    def __init__(self, params: M.LlavaParams, cfg: M.LlavaConfig, *,
                 eos_id: int, draft_len: int = 8, pool=None):
        super().__init__(pool)
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.draft_len = draft_len

    def _make(self, b: int, l: int, gen_cap: int, device) -> _SpecStatic:
        l_out = l + self.cfg.num_patches - 1
        zeros = _zeros(device)
        return _SpecStatic(
            cache=L.init_cache(self.cfg.decoder, b, l_out + gen_cap,
                               self.params.decoder.precision.compute_dtype,
                               device, quant=self.cfg.kv_quant),
            hist=zeros(b, l + gen_cap), n_gen=zeros(), rounds=zeros(),
            prompt_valid=zeros(b, l_out, dtype=torch.bool),
            n_valid=zeros(b), l_out=l_out)

    def _round(self, st: _SpecStatic, max_new_tokens: int) -> None:
        """One verify round: the body that is captured."""
        dec = self.params.decoder
        g = self.draft_len
        b, width = st.hist.shape
        gen_cap = max_new_tokens + g + 1
        l = width - gen_cap
        dev = st.hist.device
        window = torch.arange(g + 1, device=dev)
        gen_slots = torch.arange(gen_cap, device=dev)
        # n_gen tokens are known; the latest one's K/V is not cached yet
        cur_len = l + st.n_gen
        cur = torch.gather(st.hist, 1,
                           (cur_len - 1).reshape(1, 1).expand(b, 1))
        draft = bigram_draft(st.hist, cur_len, g)
        inp = torch.cat([cur, draft], dim=1)
        pos = st.n_valid[:, None] + st.n_gen - 1 + window[None]
        valid = torch.cat([st.prompt_valid, (
            gen_slots < st.n_gen + g)[None].expand(b, gen_cap)], dim=1)
        slots = (st.l_out + st.n_gen - 1 + window)[None].expand(b, g + 1)
        h, _ = dec(L.embed_tokens(dec, inp), pos, attn_mask=valid,
                   cache=st.cache, cache_index=slots)
        y = L.logits_fn(dec, h).argmax(dim=-1)
        agree = torch.cumprod((draft == y[:, :g]).long(), dim=1)
        a = agree.sum(dim=1).amin().clamp_min(0)
        a = torch.minimum(a, max_new_tokens - st.n_gen - 1)
        st.hist.scatter_(1, (cur_len + window)[None].expand(b, g + 1), y)
        st.n_gen.add_(a + 1)
        st.rounds.add_(1)

    def _load(self, st: _SpecStatic, input_ids, pre: M.Prefill) -> None:
        l = input_ids.shape[1]
        # the text prompt (the image placeholder id never matches a
        # generated token), then what is generated from column l on
        st.hist.zero_()
        st.hist[:, :l] = input_ids
        st.hist[:, l] = pre.logits.argmax(dim=-1)
        st.n_gen.fill_(1)
        st.rounds.zero_()
        st.prompt_valid.copy_(pre.slot_valid[:, :st.l_out])
        st.n_valid.copy_(pre.n_valid)

    def _start(self, input_ids, text_mask, pixel_values,
               max_new_tokens: int) -> _SpecStatic:
        """The key's static tensors, the prefill run into its cache and the
        round captured if it was not: ready for the first round."""
        b, l = input_ids.shape
        gen_cap = max_new_tokens + self.draft_len + 1
        device = input_ids.device
        st = self._lookup((b, l, max_new_tokens),
                          lambda: self._make(b, l, gen_cap, device))
        pre = M.prefill(self.params, self.cfg, input_ids, text_mask,
                        pixel_values, max_new_tokens=gen_cap, cache=st.cache)
        self._load(st, input_ids, pre)
        if max_new_tokens > 1 and st.step is None and self._capture(
                st, lambda: self._round(st, max_new_tokens), device):
            self._load(st, input_ids, pre)       # the warm-up round ran
        return st

    def _decode(self, st: _SpecStatic, max_new_tokens: int) -> None:
        """Verify rounds until `max_new_tokens` tokens are known."""
        while int(st.n_gen) < max_new_tokens:    # one host read a round
            self._replay(st)

    @torch.inference_mode()
    def generate(self, input_ids, text_mask, pixel_values, *,
                 max_new_tokens: int):
        st = self._start(input_ids, text_mask, pixel_values, max_new_tokens)
        self._decode(st, max_new_tokens)
        l = input_ids.shape[1]
        out = st.hist[:, l:l + max_new_tokens]
        return pad_after_eos(out, self.eos_id), int(st.rounds)
