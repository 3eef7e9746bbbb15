"""The port's continuous-batching engine (`models/inflight.py`) on the tiny
LLaVA in fp32 on the CPU: the cases of the JAX package's
`tests/test_inflight.py` (less its three on negotiated XLA layouts, which
the port does not carry over), on fixed token ids.

Every greedy request's tokens are held to the port's `generate_greedy` of
that request alone, and, with staggered admissions, a batched admission of
mixed lengths and the int8 cache, to the JAX `InflightEngine` on the same
weights (`io/from_jax.py`), under the near-tie rule of
`test_torch_near_tie.check_tokens`. The batched admission of mixed lengths
is also the check that the flash prefill, which takes no padding mask, is
exact for right-padded prompts. Sampled slots are held to the JAX per-row
semantics on injected noise. Also `serve --inflight`: the server, its
stream and /health, and the CLI. On the CPU the engine runs its chunk
eagerly; `tests/test_torch_cuda_kernels.py` holds the captured chunk to the
eager one on the card.
"""

import contextlib
import dataclasses
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import sampling as JS
from law_of_vision_representation_in_mllms_tpu.models.inflight import (
    InflightEngine as JEngine)
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import sampling as TS
from law_of_vision_representation_in_mllms_torch.models.inflight import (
    InflightEngine)
from law_of_vision_representation_in_mllms_torch.models.splice import (
    IMAGE_TOKEN_INDEX)

from test_torch_decode import tiny_models
from test_torch_near_tie import (check_tokens, jax_forced_logits,
                                 port_forced_logits)

torch.set_num_threads(1)

EOS = 3


@pytest.fixture(scope="module")
def tiny():
    return tiny_models(seed=3)


def _request(rng, l):
    ids = rng.randint(4, 250, size=(1, l)).astype(np.int64)
    ids[0, 0] = IMAGE_TOKEN_INDEX
    return ids, np.ones((1, l), bool), [rng.randn(1, 28, 28, 3).astype(
        np.float32)]


def _port_inputs(req):
    ids, mask, px = req
    return (torch.from_numpy(ids), torch.from_numpy(mask),
            [torch.from_numpy(p) for p in px])


def _padded(row, n):
    return list(row) + [EOS] * (n - len(row))


def _check_greedy(tcfg, params, req, got, max_new):
    """`got` against the port's `generate_greedy` of the request alone."""
    want = TM.generate_greedy(params, tcfg, *_port_inputs(req),
                              max_new_tokens=max_new, eos_id=EOS)[0].tolist()
    check_tokens([want], [_padded(got, max_new)], lambda toks:
                 port_forced_logits(params, tcfg, *_port_inputs(req), toks))


def _check_jax(jcfg, jparams, req, got, want, max_new):
    """`got` against the JAX engine's tokens `want` for the request."""
    ids, mask, px = req
    check_tokens([_padded(want, max_new)], [_padded(got, max_new)],
                 lambda toks: jax_forced_logits(
                     jparams, jcfg, jnp.asarray(ids, jnp.int32),
                     jnp.asarray(mask), [jnp.asarray(p) for p in px], toks,
                     J_FP32))


@contextlib.contextmanager
def engine(params, cfg, **kw):
    eng = InflightEngine(params, cfg, eos_id=EOS, **kw)
    try:
        yield eng
    finally:
        eng.shutdown()


def _jax_engine_tokens(jcfg, jparams, reqs, max_new, **kw):
    eng = JEngine(jparams, jcfg, eos_id=EOS, precision=J_FP32,
                  use_flash=False, **kw)
    try:
        handles = [eng.submit(r[0].astype(np.int32), r[1], r[2], m)
                   for r, m in zip(reqs, max_new)]
        return [h.result(timeout=120).tolist() for h in handles]
    finally:
        eng.shutdown()


def _wait_decoding(handle):
    """Until the request has a slot and its first tokens."""
    for _ in range(1000):
        if handle.tokens or handle.event.is_set():
            return
        time.sleep(0.005)


def test_inflight_matches_generate_greedy_and_jax(tiny):
    """3 requests through 2 slots: the third joins whichever slot frees
    first, mid-decode of the other; then one submitted only after another
    is decoding (a staggered admission)."""
    jcfg, jparams, tcfg, params = tiny
    rng = np.random.RandomState(0)
    reqs = [_request(rng, l) for l in (8, 12, 8, 16)]
    max_new = [10, 6, 10, 12]
    with engine(params, tcfg, n_slots=2, prompt_cap=32, gen_cap=16,
                chunk=4) as eng:
        handles = [eng.submit(*r, m) for r, m in zip(reqs[:3], max_new)]
        outs = [h.result(timeout=120).tolist() for h in handles]
        late = eng.submit(*reqs[0], 12)
        _wait_decoding(late)
        late_b = eng.submit(*reqs[3], 12)
        outs += [late.result(timeout=120).tolist(),
                 late_b.result(timeout=120).tolist()]
        assert eng.dispatches >= 1 and eng.captures == 0
        assert eng.replays == eng.dispatches
    reqs = reqs[:3] + [reqs[0], reqs[3]]
    max_new += [12]
    for r, got, m in zip(reqs, outs, max_new):
        _check_greedy(tcfg, params, r, got, m)
    want = _jax_engine_tokens(jcfg, jparams, reqs[:3], max_new[:3],
                              n_slots=2, prompt_cap=32, gen_cap=16, chunk=4)
    for r, got, w, m in zip(reqs, outs, want, max_new):
        _check_jax(jcfg, jparams, r, got, w, m)


def test_inflight_batched_admission_of_mixed_lengths(tiny):
    """5 requests of prompt lengths 6-17 through 3 slots: a burst admits by
    batched prefills of right-padded rows (the flash prefill takes no
    padding mask), and every request still gets its own greedy tokens and
    the JAX engine's."""
    jcfg, jparams, tcfg, params = tiny
    rng = np.random.RandomState(8)
    reqs = [_request(rng, l) for l in (6, 9, 17, 6, 12)]
    max_new = [10, 4, 8, 12, 6]
    with engine(params, tcfg, n_slots=3, prompt_cap=32, gen_cap=16,
                chunk=3) as eng:
        handles = [eng.submit(*r, m) for r, m in zip(reqs, max_new)]
        outs = [h.result(timeout=120).tolist() for h in handles]
        assert eng.admissions == 5
        assert eng.prefills < 5          # some rows shared a prefill
    want = _jax_engine_tokens(jcfg, jparams, reqs, max_new, n_slots=3,
                              prompt_cap=32, gen_cap=16, chunk=3)
    for r, got, w, m in zip(reqs, outs, want, max_new):
        _check_greedy(tcfg, params, r, got, m)
        _check_jax(jcfg, jparams, r, got, w, m)


def test_inflight_kv_quant_int8(tiny):
    """The engine on an int8 cache (codes and scales in the global cache,
    the local prefill caches and the store): each request's tokens are
    `generate_greedy`'s under the same cache and the JAX engine's; a
    repeated prompt is served from the store."""
    jcfg, jparams, tcfg, params = tiny
    jcfg = dataclasses.replace(jcfg, kv_quant="int8")
    tcfg = dataclasses.replace(tcfg, kv_quant="int8")
    rng = np.random.RandomState(22)
    reqs = [_request(rng, l) for l in (8, 8, 12)]
    with engine(params, tcfg, n_slots=2, prompt_cap=32, gen_cap=16, chunk=4,
                prefix_cache=4) as eng:
        k, _, k_scale, _ = eng.cache[0]
        assert k.dtype == torch.int8 and k_scale.shape == k.shape[:-1]
        outs = [eng.submit(*r, 8).result(timeout=120).tolist()
                for r in reqs]
        again = eng.submit(*reqs[0], 8).result(timeout=120).tolist()
        assert eng.prefix_hits == 1 and again == outs[0]
    want = _jax_engine_tokens(jcfg, jparams, reqs, [8] * 3, n_slots=2,
                              prompt_cap=32, gen_cap=16, chunk=4)
    for r, got, w in zip(reqs, outs, want):
        _check_greedy(tcfg, params, r, got, 8)
        _check_jax(jcfg, jparams, r, got, w, 8)


def test_inflight_rejects_overlong_prompt(tiny):
    _, _, tcfg, params = tiny
    with engine(params, tcfg, n_slots=1, prompt_cap=16, gen_cap=8) as eng:
        with pytest.raises(ValueError, match="prompt_cap"):
            eng.submit(*_request(np.random.RandomState(2), 24), 4)


def test_inflight_cancel_frees_slot(tiny):
    """cancel() retires a decoding slot early, and a queued request then
    takes it; a request cancelled while queued never takes a slot."""
    _, _, tcfg, params = tiny
    rng = np.random.RandomState(4)
    ra, rb = _request(rng, 8), _request(rng, 8)
    with engine(params, tcfg, n_slots=1, prompt_cap=32, gen_cap=16,
                chunk=2) as eng:
        ha = eng.submit(*ra, 16)
        _wait_decoding(ha)
        ha.cancel()
        hb = eng.submit(*rb, 8)
        got = hb.result(timeout=120).tolist()
        _check_greedy(tcfg, params, rb, got, 8)
        assert ha.event.wait(timeout=60) and len(ha.tokens) < 16
        he = eng.submit(*ra, 16)              # holds the one slot
        _wait_decoding(he)
        hc = eng.submit(*ra, 16)
        hd = eng.submit(*rb, 8)               # queued behind hc
        hc.cancel()
        admitted = eng.admissions
        he.cancel()
        assert hd.result(timeout=120).tolist() == got
        assert hc.event.is_set() and hc.tokens == []
        assert eng.admissions == admitted + 1     # hd alone


def test_inflight_prefix_cache(tiny):
    """An exact repeat admits from the store with no prefill and gives the
    same tokens; another prompt, or the same text with another image,
    misses; the LRU evicts beyond its entry count."""
    _, _, tcfg, params = tiny
    rng = np.random.RandomState(11)
    ra, rb = _request(rng, 8), _request(rng, 12)
    rc = (ra[0].copy(), ra[1].copy(), [p + 1.0 for p in ra[2]])
    with engine(params, tcfg, n_slots=2, prompt_cap=32, gen_cap=16, chunk=3,
                prefix_cache=2) as eng:
        def run(req, hits, prefills):
            got = eng.submit(*req, 8).result(timeout=120).tolist()
            assert (eng.prefix_hits, eng.prefills) == (hits, prefills)
            return got
        out_a = run(ra, 0, 1)
        assert run(ra, 1, 1) == out_a          # a hit: no prefill
        out_b = run(rb, 1, 2)
        out_c = run(rc, 1, 3)                  # same text, new image: miss
        assert eng.stats()["prefix_entries"] == 2      # ra evicted
        assert run(ra, 1, 4) == out_a          # evicted: miss, stored again
        assert run(ra, 2, 4) == out_a
    for r, got in ((ra, out_a), (rb, out_b), (rc, out_c)):
        _check_greedy(tcfg, params, r, got, 8)


def test_inflight_prefix_cache_byte_budget(tiny):
    """`prefix_cache_bytes` bounds the store by bytes: the count follows
    puts and evictions, the newest entry survives alone over the budget,
    and putting a key that is stored leaves the count equal to the
    entries' sum."""
    _, _, tcfg, params = tiny
    rng = np.random.RandomState(11)
    ra, rb = _request(rng, 8), _request(rng, 12)
    with engine(params, tcfg, n_slots=2, prompt_cap=32, gen_cap=16, chunk=3,
                prefix_cache=8, prefix_cache_bytes=1) as eng:
        eng.submit(*ra, 8).result(timeout=120)
        st = eng.stats()
        assert st["prefix_entries"] == 1
        entry_bytes = st["prefix_bytes"]
        row_bytes = sum(x.nbytes for layer in eng.cache for x in layer) // 2
        assert row_bytes < entry_bytes < row_bytes + 4096
        eng.submit(*rb, 8).result(timeout=120)
        assert eng.stats()["prefix_entries"] == 1      # the budget evicted ra
        hits = eng.prefix_hits
        eng.submit(*rb, 8).result(timeout=120)
        assert eng.prefix_hits == hits + 1
    with engine(params, tcfg, n_slots=2, prompt_cap=32, gen_cap=16, chunk=3,
                prefix_cache=8, prefix_cache_bytes=4 * entry_bytes) as eng:
        eng.submit(*ra, 8).result(timeout=120)
        eng.submit(*rb, 8).result(timeout=120)
        assert eng.stats()["prefix_entries"] == 2
        key, entry = next(iter(eng._prefix_store.items()))
        eng._store_put(key, entry)                     # the same key again
        assert eng.stats()["prefix_entries"] == 2
        assert eng._prefix_bytes == sum(
            eng._entry_nbytes(e) for e in eng._prefix_store.values())


def test_inflight_partial_prefix_reuse(tiny):
    """A prompt sharing its image and a leading run of text with a stored
    one reuses the stored row's first p slots and prefills only its text
    suffix, with the tokens of a full prefill; the combined prompt is
    stored, so its repeat is a full hit; another image gets no reuse."""
    _, _, tcfg, params = tiny
    rng = np.random.RandomState(31)
    ids_a, mask, px = _request(rng, 24)
    ids_b = ids_a.copy()
    ids_b[0, 20:] = rng.randint(4, 250, size=4)
    ids_c = ids_a.copy()
    ids_c[0, 21:] = rng.randint(4, 250, size=3)
    px_c = [p + 1.0 for p in px]
    with engine(params, tcfg, n_slots=2, prompt_cap=32, gen_cap=16, chunk=3,
                prefix_cache=4, prefix_block=8) as eng:
        out_a = eng.submit(ids_a, mask, px, 8).result(timeout=120).tolist()
        out_b = eng.submit(ids_b, mask, px, 8).result(timeout=120).tolist()
        assert (eng.partial_hits, eng.prefills) == (1, 1)
        again = eng.submit(ids_b, mask, px, 8).result(timeout=120).tolist()
        assert (eng.prefix_hits, eng.partial_hits) == (1, 1)
        assert again == out_b
        out_c = eng.submit(ids_c, mask, px_c, 8).result(timeout=120).tolist()
        assert (eng.partial_hits, eng.prefills) == (1, 2)
    for r, got in (((ids_a, mask, px), out_a), ((ids_b, mask, px), out_b),
                   ((ids_c, mask, px_c), out_c)):
        _check_greedy(tcfg, params, r, got, 8)


def test_inflight_partial_hits_in_one_round_at_a_full_store(tiny):
    """Two partial hits on different stored prompts, admitted in one round
    at a full store (`prefix_cache=2`): the first one's put evicts the entry
    the second had matched, so the second is looked up again at its
    admission and still gets its greedy tokens."""
    _, _, tcfg, params = tiny
    rng = np.random.RandomState(41)
    ids_a, mask, px = _request(rng, 24)
    ids_b = ids_a.copy()
    ids_b[0, 10:] = rng.randint(4, 250, size=14)
    ids_a2, ids_b2 = ids_a.copy(), ids_b.copy()
    ids_a2[0, 20:] = rng.randint(4, 250, size=4)
    ids_b2[0, 20:] = rng.randint(4, 250, size=4)
    with engine(params, tcfg, n_slots=3, prompt_cap=32, gen_cap=16, chunk=2,
                prefix_cache=2, prefix_block=8) as eng:
        for ids in (ids_a, ids_b):
            eng.submit(ids, mask, px, 4).result(timeout=120)
        # the engine waits inside the chunk of an exact hit on b (the store
        # order stays a, b) while a2 and b2 queue, so one round admits both
        inside, gate = threading.Event(), threading.Event()
        step = eng._step

        def held_step():
            inside.set()
            gate.wait(60)
            return step()
        eng._step = held_step
        hold = eng.submit(ids_b, mask, px, 8)
        assert inside.wait(60)
        h_a2 = eng.submit(ids_a2, mask, px, 8)
        h_b2 = eng.submit(ids_b2, mask, px, 8)
        gate.set()
        out_a2 = h_a2.result(timeout=120).tolist()
        out_b2 = h_b2.result(timeout=120).tolist()
        hold.result(timeout=120)
        assert eng.prefix_hits == 1 and eng.partial_hits >= 1
        assert eng.stats()["prefix_entries"] == 2
    _check_greedy(tcfg, params, (ids_a2, mask, px), out_a2, 8)
    _check_greedy(tcfg, params, (ids_b2, mask, px), out_b2, 8)


def test_sample_rows_matches_jax_per_row_on_its_noise():
    """`sample_rows` with a temperature and a top-p a row is the JAX
    `sample_token` of each row with its traced knobs, on JAX's Gumbel draws;
    rows with temperature <= 0 take the exact argmax."""
    rng = np.random.RandomState(5)
    logits = rng.randn(6, 64).astype(np.float32) * 2
    temp = np.array([0.0, 0.7, 1.0, -1.0, 2.5, 1.7], np.float32)
    topp = np.array([1.0, 0.9, 0.5, 1.0, 1.0, 1e-9], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = [int(JS.sample_token(jnp.asarray(logits[i]), keys[i],
                                jnp.asarray(temp[i]), jnp.asarray(topp[i])))
            for i in range(6)]
    noise = np.stack([np.asarray(jax.random.gumbel(keys[i], (64,),
                                                   jnp.float32))
                      for i in range(6)])
    got = TS.sample_rows(torch.from_numpy(logits), torch.from_numpy(temp),
                         torch.from_numpy(topp), torch.from_numpy(noise))
    assert got.tolist() == want
    assert got[0] == logits[0].argmax() and got[3] == logits[3].argmax()
    assert got[5] == logits[5].argmax()       # a nucleus of one token


def test_inflight_per_slot_sampling(tiny):
    """Greedy and sampled slots in one chunk: a greedy request and a sampled
    one whose nucleus is a single token both give the greedy tokens while a
    truly sampled one decodes beside them; a seed repeats its draws."""
    _, _, tcfg, params = tiny
    rng = np.random.RandomState(21)
    ra, rb, rc = _request(rng, 8), _request(rng, 12), _request(rng, 8)

    def run(seed):
        with engine(params, tcfg, n_slots=3, prompt_cap=32, gen_cap=16,
                    chunk=3, sample_seed=seed) as eng:
            ha = eng.submit(*ra, 10)
            hb = eng.submit(*rb, 10, temperature=1.7, top_p=1e-9)
            hc = eng.submit(*rc, 10, temperature=1.0, top_p=0.95)
            outs = [h.result(timeout=120).tolist() for h in (ha, hb, hc)]
            assert (True,) in eng._keys       # the sampling chunk ran
        return outs
    out_a, out_b, out_c = run(5)
    _check_greedy(tcfg, params, ra, out_a, 10)
    _check_greedy(tcfg, params, rb, out_b, 10)
    assert len(out_c) <= 10
    assert all(0 <= t < tcfg.decoder.vocab_size for t in out_c)
    assert run(5)[2] == out_c


# ---- serve --inflight ------------------------------------------------------

def _png_url(seed):
    import base64
    from io import BytesIO
    from PIL import Image
    buf = BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (40, 32, 3), np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def _payload(seed, text, **kw):
    return {"max_tokens": 6, **kw, "messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": _png_url(seed)}},
        {"type": "text", "text": text}]}]}


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode()


def test_served_inflight_matches_generate_until():
    """`LMMServer(inflight=True)`: two concurrent chat completions answer as
    the adapter's `generate_until` does; a `stream: true` request receives
    each token as a delta before its last; /health carries the engine's
    counts. The adapter's decoders are never built."""
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    from law_of_vision_representation_in_mllms_torch.serve import (
        LMMServer, _parse_messages)
    from test_torch_near_tie import use_crc_ids

    lmm = build_lmm(RunConfig.from_dict(
        {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit"},
         "train": {"bf16": False}}), device="cpu")
    use_crc_ids(lmm)
    payloads = [_payload(i, text) for i, text in
                enumerate(("describe the image", "what is shown here"))]
    srv = LMMServer(lmm, port=0, inflight=True, inflight_kwargs=dict(
        n_slots=2, prompt_cap=64, gen_cap=8, chunk=2))
    srv.start_background()
    try:
        got = [None, None]

        def hit(i):
            got[i] = json.loads(_post(srv.port, payloads[i]))[
                "choices"][0]["message"]["content"]
        threads = [threading.Thread(target=hit, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        body = _post(srv.port, dict(payloads[0], stream=True))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/health") as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
    reqs = [Instance("generate_until", {}, i, "serve",
                     (_parse_messages(p["messages"])[0],
                      {"max_new_tokens": 6}),
                     visual=_parse_messages(p["messages"])[1])
            for i, p in enumerate(payloads)]
    want = lmm.generate_until(reqs)
    assert got == want and all(got)
    events = [json.loads(line[6:]) for line in body.split("\n")
              if line.startswith("data: {")]
    deltas = [e["choices"][0]["delta"].get("content") for e in events[1:-1]]
    assert len(deltas) > 1 and "".join(deltas).strip() == want[0]
    assert body.rstrip().endswith("data: [DONE]")
    stats = health["inflight"]
    assert health["requests"] == 3 and "queued" not in health
    assert stats["admissions"] == stats["completions"] == 3
    assert stats["n_slots"] == 2 and stats["dispatches"] >= 1
    assert lmm._chunked_dec is None and lmm._spec_dec is None


def test_inflight_many_concurrent_submitters(tiny):
    """12 threads submit and cancel against a 3-slot engine at once, with
    a short switch interval: every request that is not cancelled completes
    with its own greedy tokens, each cancelled one completes, and the
    engine's counts add up (no slot or request lost between threads)."""
    import sys
    _, _, tcfg, params = tiny
    rng = np.random.RandomState(40)
    reqs = [_request(rng, l) for l in (6, 9, 12, 7)]
    budgets = [5, 7, 3, 6]
    results, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with engine(params, tcfg, n_slots=3, prompt_cap=32, gen_cap=8,
                    chunk=2) as eng:
            def client(i):
                try:
                    j = i % len(reqs)
                    h = eng.submit(*reqs[j], budgets[j])
                    if i % 4 == 3:
                        h.cancel()
                    results[i] = (j, h.result(timeout=120).tolist(),
                                  i % 4 == 3)
                except Exception as e:  # noqa: BLE001 — fail the test below
                    errors.append(e)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            stats = eng.stats()
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(results) == 12
    for j, got, cancelled in results.values():
        if not cancelled:
            _check_greedy(tcfg, params, reqs[j], got, budgets[j])
    assert stats["completions"] == stats["admissions"] <= 12
    assert stats["active_slots"] == 0 and stats["queued"] == 0
    assert stats["tokens_out"] == sum(len(g) for _, g, _ in
                                      results.values())
