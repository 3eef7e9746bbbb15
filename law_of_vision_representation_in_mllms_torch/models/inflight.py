"""Continuous (in-flight) batching engine for serving (counterpart of the
JAX package's `models/inflight.py`).

Requests join and leave a running decode batch between chunks instead of
riding a wave to its end (sglang's scheduling model, which the reference
serves through):

- A fixed pool of `n_slots` decode slots shares ONE global KV cache of
  `t_max = prompt_cap + num_patches - 1 + gen_cap` slots a row
  (`llama.init_cache`, int8 codes and scales under `cfg.kv_quant`). A
  slot's prompt sits in its first `l_out_max = prompt_cap + num_patches - 1`
  cache slots (a shorter prompt masks the tail), its generated tokens from
  `l_out_max` on.
- Admission is one prefill of `k` requests of one prompt bucket (a power of
  two, `_bucket`; `k` padded to a power of two by repeating row 0): the
  tower (kernel 1 on the card), the splice and the decoder's flash prefill
  at cache slot 0 (kernel 2) into a local cache, whose rows are then copied
  into their slots of the global cache (`_install`, an indexed copy, no
  allocation). The prompts are right-padded, so under causality no valid
  query sees a pad key, which is kernel 2's contract (it takes no padding
  mask). The first token comes from the prefill's last valid position.
- Decoding is ONE chunk of `chunk` steps advancing EVERY slot: each row
  writes its own cache slot `l_out_max + t`, at its own RoPE position, under
  its own validity row `prompt_row ++ (arange(gen_cap) <= t)`; the decoder
  takes the slots as a device [B] tensor and kernel 3 a [B, T] mask. On the
  card the chunk is captured once as a CUDA graph and replayed
  (`models/decode.py`'s `Replayable`), its inputs in static tensors that
  the host fills before each replay; on the CPU it runs eagerly. A failed
  capture or replay fails the requests in the slots; nothing falls back to
  eager launches.
- Between chunks the host harvests the tokens, frees a slot at EOS or at its
  request's token budget, and admits queued requests into free slots.

Inactive slots ride along as masked garbage in their own rows; an
admission overwrites the whole row. A slot that runs past its budget inside
a chunk writes its last cache slot again (the JAX engine's
`dynamic_update_slice` clamps the same way); those tokens are never
harvested.

Per-slot sampling: `submit(..., temperature=, top_p=)` samples that request
while its neighbours stay greedy, in the same chunk
(`sampling.sample_rows`: the temperature and top-p are tensors a slot,
`temperature <= 0` the exact argmax). The Gumbel noise is drawn from the
engine's `torch.Generator(sample_seed)` into a static [chunk, n_slots, V]
buffer before a replay, and only when a slot samples, which keeps the
generator out of the graph; a chunk without sampled slots replays a graph
without the sort. A sampled request's first token is drawn by
`sampling.sample_token` from the prefill's last logits with the same
generator (`_first_token`), so the prompt-KV store stays sampling-agnostic.

Prompt-KV store (`prefix_cache=N`): each admitted prompt's cache row, first
token, last logits and validity row are kept in an LRU of N entries (and,
with `prefix_cache_bytes`, of that many bytes), keyed by the token ids and
the pixel bytes. An exact hit installs the stored row: no tower pass, no
prefill. A partial hit (same image, a shared leading run of text) reuses
the stored row's first `p` slots, `p` the longest common spliced prefix
rounded down to `prefix_block`, and prefills only the text suffix from
slot `p` (`_suffix_prefill`, the plain masked attention, as the JAX engine
runs it without flash); the combined prompt is stored back.

The JAX engine's `negotiate_layouts` (XLA boundary layouts) is not carried
over: a PyTorch tensor has one layout.

Threading: only the engine thread touches the device. `submit` takes host
arrays; a server's handler threads tokenise and preprocess, then submit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from . import llama as L
from . import llava as M
from .decode import Replayable, _Keyed
from .sampling import sample_rows, sample_token
from .splice import IMAGE_TOKEN_INDEX


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class _Request:
    __slots__ = ("ids", "mask", "pixels", "max_new", "tokens", "event",
                 "error", "stream_q", "cancelled", "key", "pixkey",
                 "temperature", "top_p")

    def __init__(self, ids, mask, pixels, max_new, temperature=0.0,
                 top_p=1.0):
        self.ids = ids
        self.mask = mask
        self.pixels = pixels
        self.max_new = max_new
        self.temperature = temperature
        self.top_p = top_p
        self.key: Optional[bytes] = None     # prompt-store key (lazy)
        self.pixkey: Optional[bytes] = None  # pixels-only hash (lazy)
        self.tokens: List[int] = []
        self.event = threading.Event()
        self.error: Optional[Exception] = None
        # live token feed for streaming consumers (None = end of stream)
        self.stream_q: "queue.Queue[Optional[int]]" = queue.Queue()
        self.cancelled = False

    def cancel(self):
        """Ask the engine to stop decoding this request (client hung up,
        stop string hit). The slot frees at the next harvest; the tokens so
        far stay available through `result()`."""
        self.cancelled = True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.event.wait(timeout):
            raise TimeoutError("inflight request timed out")
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)

    def iter_tokens(self, timeout: Optional[float] = 600):
        """Yield token ids as the engine produces them (SSE streaming);
        raises the request's error, if any, at the end of the stream."""
        while True:
            tok = self.stream_q.get(timeout=timeout)
            if tok is None:
                break
            yield tok
        if self.error is not None:
            raise self.error


@dataclasses.dataclass
class _Chunk:
    """What `_Keyed` keeps per graph: the greedy chunk and the sampling
    chunk read and write the same static tensors of the engine."""
    step: Optional[Replayable] = None


class InflightEngine(_Keyed):
    """Slot-pool continuous-batching engine over one model's params. Launch
    accounting as `models.decode`'s decoders: `captures`, `replays`,
    `recorded`, `graph_launches()`."""

    max_keys = 2              # the greedy chunk and the sampling chunk

    def __init__(self, params: M.LlavaParams, cfg: M.LlavaConfig, *,
                 eos_id: int, n_slots: int = 4, prompt_cap: int = 256,
                 gen_cap: int = 256, chunk: int = 4, prefix_cache: int = 0,
                 prefix_block: int = 64, prefix_cache_bytes: int = 0,
                 sample_seed: int = 0):
        super().__init__(None)
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.n_slots = n_slots
        self.prompt_cap = prompt_cap
        self.gen_cap = gen_cap
        self.chunk = chunk
        self.device = params.decoder.embed.device
        # prompt slots cover the LONGEST bucket's spliced length; shorter
        # prompts mask the tail (prompt_row False there)
        self.l_out_max = prompt_cap + cfg.num_patches - 1
        self.t_max = self.l_out_max + gen_cap
        dev = self.device
        with torch.inference_mode():
            self.cache = L.init_cache(
                cfg.decoder, n_slots, self.t_max,
                params.decoder.precision.compute_dtype, dev,
                quant=cfg.kv_quant)

            def zeros(*shape, dtype=torch.long):
                return torch.zeros(shape, dtype=dtype, device=dev)
            # the chunk's static inputs and outputs
            self._s_tok = zeros(n_slots)
            self._s_pos = zeros(n_slots)
            self._s_t = zeros(n_slots)
            self._s_prompt = zeros(n_slots, self.l_out_max, dtype=torch.bool)
            self._s_temp = zeros(n_slots, dtype=torch.float32)
            self._s_topp = zeros(n_slots, dtype=torch.float32)
            self._s_noise = None          # [chunk, n_slots, V], on first use
            self._s_out = zeros(n_slots, chunk)
            self._gen_slots = torch.arange(gen_cap, device=dev)
        self._generator = torch.Generator(dev).manual_seed(sample_seed)

        # prompt-KV LRU: key -> (k=1 cache row, first token, last logits,
        # n_valid, prompt row, valid token ids, pixel hash)
        self.prefix_cache = prefix_cache
        self.prefix_block = prefix_block
        # optional BYTE bound of the store (0 = the entry count only): one
        # stored prompt row of LLaVA-1.5-7B at t_max 671 is 0.35 GB in bf16
        self.prefix_cache_bytes = prefix_cache_bytes
        self._prefix_bytes = 0
        self._prefix_store: "OrderedDict[bytes, tuple]" = OrderedDict()
        self.prefix_hits = 0
        self.partial_hits = 0

        # host-side slot state
        self._slot_req: List[Optional[_Request]] = [None] * n_slots
        self._tok = np.full((n_slots,), eos_id, np.int64)
        self._pos = np.zeros((n_slots,), np.int64)
        self._t = np.zeros((n_slots,), np.int64)
        self._prompt_rows = np.zeros((n_slots, self.l_out_max), bool)
        self._active = np.zeros((n_slots,), bool)
        self._temp = np.zeros((n_slots,), np.float32)
        self._topp = np.ones((n_slots,), np.float32)

        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = False
        self.dispatches = 0            # chunks run
        self.prefills = 0              # full admission prefills (tower + LLM)
        self.tokens_out = 0            # harvested (delivered) tokens
        self.admissions = 0
        self.completions = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---------------- device work (the engine thread only) ----------------

    def _install(self, local: L.Cache, src: int, slot: int) -> None:
        """Copy row `src` of a local cache into the global cache's row
        `slot`, every layer's codes and scales, in place."""
        for g_layer, l_layer in zip(self.cache, local):
            for g, lo in zip(g_layer, l_layer):
                g[slot].copy_(lo[src])

    @staticmethod
    def _row(local: L.Cache, src: int) -> L.Cache:
        """Row `src` of a local cache as a k=1 cache of its own (the
        prompt store's entry; a view would keep the whole batch alive)."""
        return [tuple(x[src:src + 1].clone() for x in layer)
                for layer in local]

    def _prefill(self, ids: np.ndarray, mask: np.ndarray, pixels):
        """One prefill of k rows into a local cache of t_max slots: the
        tower, splice and flash prefill of `llava.prefill`."""
        dev = self.device
        l_out = ids.shape[1] + self.cfg.num_patches - 1
        self.prefills += 1
        return M.prefill(self.params, self.cfg,
                         torch.from_numpy(ids).to(dev),
                         torch.from_numpy(mask).to(dev),
                         [torch.from_numpy(p).to(dev) for p in pixels],
                         max_new_tokens=self.t_max - l_out)

    def _suffix_prefill(self, row: L.Cache, suffix_ids: np.ndarray, p: int,
                        key_valid: np.ndarray):
        """Text-only prefill of a suffix padded to a bucket of 16, from
        cache slot `p`, into the k=1 cache `row` (a copy of a stored
        entry), on the plain masked attention. Returns (first-token logits
        [V] fp32, greedy first token)."""
        dec = self.params.decoder
        dev = self.device
        n = len(suffix_ids)
        s_buck = _bucket(n, minimum=16)
        ids = torch.zeros((1, s_buck), dtype=torch.long, device=dev)
        ids[0, :n] = torch.from_numpy(np.asarray(suffix_ids, np.int64))
        pos = (p + torch.arange(s_buck, device=dev))[None]
        h, _ = dec(L.embed_tokens(dec, ids), pos,
                   attn_mask=torch.from_numpy(key_valid).to(dev), cache=row,
                   cache_index=p)
        logits = L.logits_fn(dec, h[:, max(n - 1, 0)])[0]
        return logits, int(logits.argmax())

    def _chunk(self, sampled: bool) -> None:
        """`chunk` steps of every slot: the body that is captured. With
        `sampled`, each step draws by `sample_rows` from the noise buffer;
        without, it takes the argmax (every slot greedy)."""
        dec = self.params.decoder
        eos = self.eos_id
        for i in range(self.chunk):
            valid = torch.cat([self._s_prompt, self._gen_slots[None]
                               <= self._s_t[:, None]], dim=1)
            # a slot past its budget rewrites its last cache slot
            slot = (self.l_out_max + self._s_t).clamp_max(self.t_max - 1)
            h, _ = dec(L.embed_tokens(dec, self._s_tok[:, None]),
                       self._s_pos[:, None], attn_mask=valid,
                       cache=self.cache, cache_index=slot)
            logits = L.logits_fn(dec, h)[:, -1]
            nxt = (sample_rows(logits, self._s_temp, self._s_topp,
                               self._s_noise[i]) if sampled
                   else logits.argmax(dim=-1))
            self._s_out[:, i] = self._s_tok
            # EOS rows emit EOS (generate_greedy's latch); the host retires
            # them between chunks
            self._s_tok.copy_(nxt.masked_fill(self._s_tok == eos, eos))
            self._s_pos.add_(1)
            self._s_t.add_(1)

    def _load(self) -> None:
        """The host's slot state into the chunk's static inputs."""
        for dst, src in ((self._s_tok, self._tok), (self._s_pos, self._pos),
                         (self._s_t, self._t),
                         (self._s_prompt, self._prompt_rows),
                         (self._s_temp, self._temp),
                         (self._s_topp, self._topp)):
            dst.copy_(torch.from_numpy(src))

    def _step(self) -> np.ndarray:
        """One chunk for every slot. Returns [n_slots, chunk + 3]: the
        tokens each slot fed, by step, then its token, position and step
        after the chunk."""
        sampled = bool((self._temp[self._active] > 0).any())
        if sampled and self._s_noise is None:
            self._s_noise = torch.empty(
                (self.chunk, self.n_slots, self.cfg.decoder.vocab_size),
                dtype=torch.float32, device=self.device)
        g = self._lookup((sampled,), _Chunk)
        self._load()
        if sampled:
            self._s_noise.exponential_(generator=self._generator).log_() \
                .neg_()
        if g.step is None and self._capture(
                g, lambda: self._chunk(sampled), self.device):
            self._load()              # the warm-up chunk moved them on
        self._replay(g)
        self.dispatches += 1
        return torch.cat([self._s_out, self._s_tok[:, None],
                          self._s_pos[:, None], self._s_t[:, None]],
                         dim=1).cpu().numpy()

    # ---------------- prompt-KV store ----------------

    @staticmethod
    def _entry_nbytes(entry: tuple) -> int:
        """Bytes one stored prompt entry holds: its cache row (codes and
        scales under an int8 cache) and its host arrays."""
        n = sum(x.nbytes for layer in entry[0] for x in layer)
        return n + sum(int(x.nbytes) for x in entry[1:]
                       if isinstance(x, np.ndarray))

    def _store_put(self, key: bytes, entry: tuple) -> None:
        """Insert into the prompt-KV LRU and evict to both bounds, the entry
        count (`prefix_cache`) and, when set, the bytes
        (`prefix_cache_bytes`). A key already stored gives back its old
        entry's bytes first. The newest entry always survives: a single
        entry over the budget would otherwise empty the store."""
        old = self._prefix_store.pop(key, None)
        if old is not None:
            self._prefix_bytes -= self._entry_nbytes(old)
        self._prefix_store[key] = entry
        self._prefix_bytes += self._entry_nbytes(entry)
        while len(self._prefix_store) > 1 and (
                len(self._prefix_store) > self.prefix_cache
                or (self.prefix_cache_bytes > 0
                    and self._prefix_bytes > self.prefix_cache_bytes)):
            _, old = self._prefix_store.popitem(last=False)
            self._prefix_bytes -= self._entry_nbytes(old)

    @staticmethod
    def _pixel_hash(h, pixels) -> None:
        for p in pixels:
            a = np.asarray(p)
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())

    @classmethod
    def _prefix_key(cls, req: _Request) -> bytes:
        """Exact-prompt identity: token ids, mask and pixel bytes (the same
        text with another image must miss)."""
        if req.key is None:
            h = hashlib.sha1()
            h.update(req.ids.tobytes())
            h.update(req.mask.tobytes())
            cls._pixel_hash(h, req.pixels)
            req.key = h.digest()
        return req.key

    @classmethod
    def _pix_key(cls, req: _Request) -> bytes:
        """Pixels-only identity: two requests sharing leading text and the
        same image can share spliced cache slots."""
        if req.pixkey is None:
            h = hashlib.sha1()
            cls._pixel_hash(h, req.pixels)
            req.pixkey = h.digest()
        return req.pixkey

    @staticmethod
    def _valid_ids(ids, mask) -> np.ndarray:
        return np.asarray(ids[0])[np.asarray(mask[0])]

    def _find_partial(self, req: _Request):
        """The longest common prefix with a stored prompt of the same image,
        in spliced cache slots, rounded down to `prefix_block`. Returns
        (store key, p, suffix ids) or None. The image token must lie inside
        the shared part and `p` must clear the image's slots, so that the
        suffix is text only."""
        if self.prefix_cache <= 0 or not self._prefix_store:
            return None
        r_ids = self._valid_ids(req.ids, req.mask)
        img_pos = np.nonzero(r_ids == IMAGE_TOKEN_INDEX)[0]
        if len(img_pos) != 1:
            return None
        idx_img = int(img_pos[0])
        npatch = self.cfg.num_patches
        pk = self._pix_key(req)
        best = None
        for key, ent in self._prefix_store.items():
            e_ids, e_pk = ent[5], ent[6]
            if e_pk != pk:
                continue
            n = min(len(r_ids), len(e_ids))
            neq = np.nonzero(r_ids[:n] != e_ids[:n])[0]
            c = int(neq[0]) if len(neq) else n
            if c <= idx_img:            # the image is not in the shared part
                continue
            p = (c - 1 + npatch) // self.prefix_block * self.prefix_block
            if p < idx_img + npatch or p < self.prefix_block:
                continue
            if p >= len(r_ids) - 1 + npatch:    # an exact repeat: full hit
                continue
            if best is None or p > best[1]:
                best = (key, p)
        if best is None:
            return None
        key, p = best
        suffix_ids = r_ids[p - npatch + 1:]
        if p + _bucket(len(suffix_ids), minimum=16) > self.t_max:
            return None                 # the padded suffix must fit the row
        return key, p, suffix_ids

    # ---------------- public API ----------------

    def submit(self, input_ids: np.ndarray, text_mask: np.ndarray,
               pixel_values, max_new_tokens: int,
               temperature: float = 0.0, top_p: float = 1.0) -> _Request:
        """Queue one request: host arrays of one row (ids [1, L], mask [1,
        L], one [1, H, W, 3] array a tower). Returns a handle whose
        `.result()` blocks for the generated token ids (EOS excluded).
        `temperature > 0` samples this request (the reference's `do_sample
        = temperature > 0`)."""
        if self._stop:
            raise RuntimeError("engine is shut down")
        l = int(np.shape(input_ids)[-1])
        if l > self.prompt_cap:
            raise ValueError(f"prompt length {l} exceeds the engine's "
                             f"prompt_cap {self.prompt_cap}")
        req = _Request(np.asarray(input_ids, np.int64).reshape(1, -1),
                       np.asarray(text_mask, bool).reshape(1, -1),
                       [np.asarray(p, np.float32) for p in pixel_values],
                       min(int(max_new_tokens), self.gen_cap),
                       float(temperature), float(top_p))
        self._q.put(req)
        return req

    def _first_token(self, req: _Request, greedy_first: int,
                     logits_row) -> int:
        """The first generated token from the prefill's last-position
        logits [V] (a tensor or a stored host array): the argmax for a
        greedy request; for a sampled one, `sample_token` with the engine's
        generator, the rule and the draws of its later tokens."""
        if req.temperature <= 0:
            return greedy_first
        row = torch.as_tensor(logits_row, device=self.device)
        return int(sample_token(row, self._generator, req.temperature,
                                req.top_p))

    def stats(self) -> Dict[str, int]:
        """Scheduler counts (served under `serve --inflight`'s /health)."""
        return {"dispatches": self.dispatches,
                "prefills": self.prefills,
                "tokens_out": self.tokens_out,
                "admissions": self.admissions,
                "completions": self.completions,
                "active_slots": int(self._active.sum()),
                "n_slots": self.n_slots,
                "queued": self._q.qsize(),
                "prefix_hits": self.prefix_hits,
                "partial_hits": self.partial_hits,
                "prefix_entries": len(self._prefix_store),
                "prefix_bytes": self._prefix_bytes,
                "captures": self.captures,
                "replays": self.replays}

    def shutdown(self):
        self._stop = True
        self._thread.join(timeout=60)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = RuntimeError("engine shutting down")
            req.stream_q.put(None)
            req.event.set()

    # ---------------- scheduler loop ----------------

    def _occupy(self, slot: int, req: _Request, tok0: int, n_valid: int,
                prompt_row: np.ndarray) -> None:
        """Slot `slot` decodes `req` from its first token `tok0`."""
        self._slot_req[slot] = req
        self._tok[slot] = tok0
        self._pos[slot] = n_valid
        self._t[slot] = 0
        self._prompt_rows[slot] = np.pad(
            prompt_row, (0, self.l_out_max - len(prompt_row)))
        self._temp[slot] = req.temperature
        self._topp[slot] = req.top_p
        self._active[slot] = True
        self.admissions += 1

    def _admit_group(self, group):
        """Admit requests of one prompt bucket with ONE prefill. group:
        [(request, slot)]; k pads to a power of two by repeating row 0 (the
        pad rows are dropped)."""
        reqs = [r for r, _ in group]
        l = min(_bucket(max(r.ids.shape[1] for r in reqs)), self.prompt_cap)
        k = _bucket(len(reqs), minimum=1)
        ids = np.zeros((k, l), np.int64)
        mask = np.zeros((k, l), bool)
        for i, r in enumerate(reqs):
            n = r.ids.shape[1]
            ids[i, :n], mask[i, :n] = r.ids[0], r.mask[0]
        ids[len(reqs):], mask[len(reqs):] = ids[0], mask[0]
        pixels = []
        for ti in range(len(reqs[0].pixels)):
            rows = [r.pixels[ti][0] for r in reqs]
            pixels.append(np.stack(rows + [rows[0]] * (k - len(reqs))))
        pre = self._prefill(ids, mask, pixels)
        first = pre.logits.argmax(dim=-1).cpu().numpy()
        last_logits = pre.logits.cpu().numpy()
        n_valid = pre.n_valid.cpu().numpy()
        prow = pre.slot_valid[:, :pre.l_out].cpu().numpy()
        for i, (req, slot) in enumerate(group):
            self._install(pre.cache, i, slot)
            tok0 = self._first_token(req, int(first[i]), pre.logits[i])
            self._occupy(slot, req, tok0, int(n_valid[i]), prow[i])
            if self.prefix_cache > 0:
                key = self._prefix_key(req)
                if key not in self._prefix_store:
                    self._store_put(key, (
                        self._row(pre.cache, i), int(first[i]),
                        last_logits[i].copy(), int(n_valid[i]),
                        self._prompt_rows[slot].copy(),
                        self._valid_ids(req.ids, req.mask),
                        self._pix_key(req)))
            # the prefill produced the first token
            self._harvest_token(slot, tok0)

    def _admit_cached(self, req: _Request, slot: int) -> None:
        """Exact store hit: the stored row into `slot`, no tower pass, no
        prefill. A sampled request draws its first token again from the
        stored logits."""
        key = self._prefix_key(req)
        row, first, last_logits, n_valid, prow = self._prefix_store[key][:5]
        self._prefix_store.move_to_end(key)
        self._install(row, 0, slot)
        self._occupy(slot, req, self._first_token(req, first, last_logits),
                     n_valid, prow)
        self.prefix_hits += 1
        self._harvest_token(slot, int(self._tok[slot]))

    def _admit_partial(self, req: _Request, slot: int, match) -> None:
        """Partial hit: a copy of the stored row keeps its first `p` slots,
        the text suffix is prefilled from slot p, the row goes into `slot`,
        and the combined prompt is stored for exact repeats."""
        store_key, p, suffix_ids = match
        entry = self._prefix_store[store_key]
        self._prefix_store.move_to_end(store_key)
        n_total = p + len(suffix_ids)
        key_valid = np.zeros((1, self.t_max), bool)
        key_valid[0, :p] = entry[4][:p]         # the stored prefix's validity
        key_valid[0, p:n_total] = True
        row = self._row(entry[0], 0)
        logits, first = self._suffix_prefill(row, suffix_ids, p, key_valid)
        self._install(row, 0, slot)
        prow = key_valid[0, :self.l_out_max]
        self._occupy(slot, req, self._first_token(req, first, logits),
                     n_total, prow)
        logits = logits.cpu().numpy()
        self.partial_hits += 1
        full_key = self._prefix_key(req)
        if full_key not in self._prefix_store:
            self._store_put(full_key, (
                row, first, logits.copy(), n_total, prow.copy(),
                self._valid_ids(req.ids, req.mask), self._pix_key(req)))
        self._harvest_token(slot, int(self._tok[slot]))

    def _harvest_token(self, slot: int, tok: int) -> None:
        req = self._slot_req[slot]
        if req is None:
            return
        if req.cancelled or tok == self.eos_id \
                or len(req.tokens) >= req.max_new:
            self._finish(slot)
        else:
            req.tokens.append(tok)
            req.stream_q.put(tok)
            self.tokens_out += 1
            if len(req.tokens) >= req.max_new:
                self._finish(slot)

    def _finish(self, slot: int):
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._active[slot] = False
        if req is not None:
            self.completions += 1
            req.stream_q.put(None)
            req.event.set()

    def _fail(self, pairs, error: Exception) -> None:
        """Fail the requests of [(request, slot or None)] with `error` and
        free their slots."""
        for req, slot in pairs:
            if slot is not None and self._slot_req[slot] is req:
                self._slot_req[slot] = None
                self._active[slot] = False
            req.error = error
            req.stream_q.put(None)
            req.event.set()

    def _run(self):
        with torch.inference_mode():
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._loop()
            else:
                self._loop()

    def _admit(self) -> bool:
        """Drain the queue into the free slots: store hits, partial hits,
        then one prefill a prompt bucket. A partial hit is looked up just
        before it is admitted: an earlier admission of the round may have
        evicted the entry it would have read, and a request left without
        one joins the full prefills. Returns whether anything was taken
        from the queue."""
        free = [i for i in range(self.n_slots) if not self._active[i]]
        pending: List[_Request] = []
        hits: List[_Request] = []
        while len(pending) + len(hits) < len(free):
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req.cancelled:               # hung up before admission
                req.stream_q.put(None)
                req.event.set()
                continue
            if (self.prefix_cache > 0
                    and self._prefix_key(req) in self._prefix_store):
                hits.append(req)
            else:
                pending.append(req)
        it = iter(free)
        for req in hits:
            slot = next(it)
            try:
                self._admit_cached(req, slot)
            except Exception as e:  # noqa: BLE001 — fail THIS request
                self._fail([(req, slot)], e)
        by_bucket: Dict[int, list] = {}
        for req in pending:
            m = self._find_partial(req)
            if m is None:
                l = min(_bucket(req.ids.shape[1]), self.prompt_cap)
                by_bucket.setdefault(l, []).append(req)
                continue
            slot = next(it)
            try:
                self._admit_partial(req, slot, m)
            except Exception as e:  # noqa: BLE001 — fail THIS request
                self._fail([(req, slot)], e)
        for reqs in by_bucket.values():
            group = [(r, next(it)) for r in reqs]
            try:
                self._admit_group(group)
            except Exception as e:  # noqa: BLE001 — fail THIS group
                self._fail(group, e)
        return bool(pending or hits)

    def _loop(self):
        while not self._stop:
            admitted = self._admit()
            if not self._active.any():
                if not admitted:
                    try:
                        req = self._q.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    self._q.put(req)     # admit at the top of the loop
                continue
            try:
                got = self._step()
            except Exception as e:   # noqa: BLE001 — fail the active slots
                # a dead engine thread would hang every caller: fail the
                # requests in flight and keep serving on a zeroed cache (the
                # graph holds these tensors: zero them, do not replace them)
                self._fail([(r, s) for s, r in enumerate(self._slot_req)
                            if r is not None], e)
                self._active[:] = False
                for layer in self.cache:
                    for x in layer:
                        x.zero_()
                continue
            toks = got[:, :self.chunk]      # the token each step fed
            self._tok = got[:, self.chunk].copy()
            self._pos = got[:, self.chunk + 1].copy()
            self._t = got[:, self.chunk + 2].copy()
            # toks[:, 0] was harvested at admission or after the previous
            # chunk; the new ones are toks[:, 1:] and the carried token
            for slot in range(self.n_slots):
                if not self._active[slot]:
                    continue
                for tk in list(toks[slot, 1:]) + [int(self._tok[slot])]:
                    if not self._active[slot]:
                        break
                    self._harvest_token(slot, int(tk))
