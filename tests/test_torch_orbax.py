"""The port's orbax reader (`io/zstd.py` over the system's `libzstd.so.1`,
`io/ocdbt.py`, `io/orbax_state.py`) against the libraries and the JAX
package that write what it reads:

- the zstd decoder on frames the `zstandard` package makes at levels 1, 19
  and 22, with the checksum and content-size flags on and off, over data
  whose frames hold compressed, raw and RLE blocks, byte for byte; a
  flipped checksum refused; the CRC-32C on its check value;
- the OCDBT reader against tensorstore on a database of several versions
  whose B-tree is four levels deep;
- `restore_raw` / `restore_params` against orbax's template-free restore
  and the JAX `restore_train_state`, exactly (bf16, fp32, int8, int32, a
  scalar, lists), unsharded and sharded over 4 host devices (several
  chunks an array); the committed fixture `tests/data/orbax_tiny` against
  its arrays; a flipped byte of a B-tree node refused by its CRC-32C.
  (`consolidate` and `model.checkpoint` on the JAX runner's own save:
  tests/test_torch_host_tools.py.)
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from law_of_vision_representation_in_mllms_tpu.io import checkpoint as jckpt
from law_of_vision_representation_in_mllms_torch.io import (
    ocdbt, orbax_state, param_io, zstd)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "orbax_tiny", "checkpoint-1")
FIXTURE_ARRAYS = os.path.join(HERE, "data", "orbax_tiny_arrays.npz")


def _payloads():
    rng = np.random.RandomState(0)
    return {
        "floats": rng.randn(150_000).astype(np.float32).tobytes(),
        "bf16_bits": (rng.randn(200_000).astype(np.float32).view(np.uint32)
                      >> 16).astype(np.uint16).tobytes(),
        "codes": rng.randint(-7, 8, 300_000).astype(np.int8).tobytes(),
        "text": b"the quick brown fox jumps over the lazy dog " * 4000,
        "incompressible": rng.bytes(140_000),
        "runs": bytes(200_000) + bytes([7]) * 70_000,
        "tiny": b"x",
        "empty": b"",
    }


def _block_types(frame: bytes):
    """The block types (0 raw, 1 RLE, 2 compressed) of one zstd frame."""
    d = frame[4]
    single, fcs, dict_flag = (d >> 5) & 1, d >> 6, d & 3
    at = 5 + (0 if single else 1) + (0, 1, 2, 4)[dict_flag] + (
        (1 if single else 0) if fcs == 0 else 1 << fcs)
    types, last = [], False
    while not last:
        h = int.from_bytes(frame[at:at + 3], "little")
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        types.append(kind)
        at += 3 + (1 if kind == 1 else size)
    return types


@pytest.mark.parametrize("level", [1, 19, 22])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("content_size", [True, False])
def test_zstd_decoder_matches_zstandard(level, checksum, content_size):
    zs = pytest.importorskip("zstandard")
    comp = zs.ZstdCompressor(level=level, write_checksum=checksum,
                             write_content_size=content_size)
    kinds = set()
    for name, data in _payloads().items():
        frame = comp.compress(data)
        kinds.update(_block_types(frame))
        got = zstd.decompress(frame, None if content_size else len(data))
        assert got.tobytes() == data, name
        # without the size, a frame that declares none decodes all the same
        assert zstd.decompress(frame).tobytes() == data, name
    assert kinds == {0, 1, 2}, kinds


def test_zstd_refuses_a_bad_checksum_and_reads_frames_back_to_back():
    zs = pytest.importorskip("zstandard")
    data = _payloads()["text"]
    frame = bytearray(zs.ZstdCompressor(level=3, write_checksum=True)
                      .compress(data))
    two = bytes(frame) + zs.ZstdCompressor(level=9).compress(b"tail")
    assert zstd.decompress(two).tobytes() == data + b"tail"
    frame[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame))
    assert zstd.crc32c(b"123456789") == 0xE3069283


def test_ocdbt_reader_matches_tensorstore(tmp_path):
    ts = pytest.importorskip("tensorstore")
    root = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": {"compression": {"id": "zstd"},
                                     "max_decoded_node_bytes": 600,
                                     "max_inline_value_bytes": 16}}).result()
    for commit in range(3):
        txn = ts.Transaction()
        for k in range(commit * 700, (commit + 1) * 700):
            kv.with_transaction(txn).write(
                f"p{k % 3}/key{k:06d}/{'x' * (k % 5)}",
                bytes([k % 256]) * (1 + k % 40)).result()
        txn.commit_async().result()
    db = ocdbt.Database(root)
    items = db.items()
    keys = ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{root}/"}).result().list()
    keys = keys.result()
    assert db.root_height >= 2 and db.generation >= 4
    assert sorted(items) == sorted(keys)
    for k in keys:
        assert items[k].read() == bytes([int(k[6:12]) % 256]) * (
            1 + int(k[6:12]) % 40), k


def _state(rng):
    return {"params": {"w": jnp.asarray(rng.randn(64, 48), jnp.float32),
                       "b": jnp.asarray(rng.randn(10), jnp.bfloat16),
                       "q": jnp.asarray(rng.randint(-7, 8, (32, 16)),
                                        jnp.int8),
                       "layers": [{"k": jnp.asarray(rng.randn(8, 4))},
                                  {"k": jnp.asarray(rng.randn(8, 4))}]},
            "step": jnp.asarray(5, jnp.int32), "lr": 0.25, "count": 3}


def _flat(tree):
    out = {}
    param_io._flatten(tree, "", out)
    return out


def _assert_exact(got, want):
    """Trees of arrays equal in structure, dtype, shape and bytes; the JAX
    bfloat16 read as the port's `V2`."""
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(lambda x: x, want))
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        want_k = np.asarray(w[k])
        if want_k.dtype.name == "bfloat16":
            want_k = want_k.view(np.dtype("V2"))
        assert g[k].dtype == want_k.dtype and g[k].shape == want_k.shape, k
        assert g[k].tobytes() == want_k.tobytes(), k


@pytest.mark.parametrize("sharded", [False, True])
def test_restore_matches_orbax_and_the_jax_restore(tmp_path, sharded):
    ocp = pytest.importorskip("orbax.checkpoint")
    state = _state(np.random.RandomState(1))
    if sharded:
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("x",))
        state = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(
            mesh, P("x") if x.ndim == 2 and x.shape[0] % 4 == 0 else P()))
            if isinstance(x, jax.Array) else x, state)
    path = jckpt.save_train_state(str(tmp_path / "run"), state, 2)
    with ocp.PyTreeCheckpointer() as ckptr:
        raw = ckptr.restore(path)
    got = orbax_state.restore_raw(path)
    _assert_exact(got, raw)
    assert got["lr"] == 0.25 and got["count"] == 3
    # the JAX restore takes a template of the whole saved tree
    template = jax.tree.map(lambda x: jnp.zeros_like(x) if isinstance(
        x, jax.Array) else x, state)
    want = jckpt.restore_train_state(path, template)["params"]
    _assert_exact(orbax_state.restore_params(path), want)
    if sharded:
        items = ocdbt.Database(path).items()
        assert b"params.w/3.0" in items and b"params.w/1.0" in items


def test_committed_fixture_holds_its_arrays():
    """tests/data/orbax_tiny (tests/make_orbax_fixture.py: the tiny LLaVA
    from 4 host devices, bf16 / int8 extras, a step) read by the port, and
    by orbax, equal to the arrays written beside it."""
    ocp = pytest.importorskip("orbax.checkpoint")
    want = param_io.load_params(FIXTURE_ARRAYS)
    got = orbax_state.restore_raw(FIXTURE)
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w) and len(w) >= 40
    assert {str(x.dtype) for x in w.values()} == {"float32", "int32", "int8",
                                                 "|V2"}
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()
    with ocp.PyTreeCheckpointer() as ckptr:
        _assert_exact(got, ckptr.restore(FIXTURE))
    chunks = [k for k in ocdbt.Database(FIXTURE).items()
              if k.startswith(b"params.decoder.embed/") and b".z" not in k]
    assert len(chunks) == 4


def test_restore_params_decodes_the_params_alone(monkeypatch):
    """`restore_raw(path, "params")` and `restore_params` decode no leaf
    outside `params` (a train state's moments are twice its parameters),
    and give what the whole restore holds under it."""
    whole = orbax_state.restore_raw(FIXTURE)
    decoded = []
    array = orbax_state._array
    monkeypatch.setattr(orbax_state, "_array", lambda items, name: (
        decoded.append(name), array(items, name))[1])
    got = orbax_state.restore_raw(FIXTURE, "params")
    assert list(got) == ["params"]
    _assert_exact(got["params"], whole["params"])
    _assert_exact(orbax_state.restore_params(FIXTURE), whole["params"])
    assert decoded and all(n.startswith("params.") for n in decoded)


def test_a_flipped_byte_is_refused_by_its_crc(tmp_path):
    path = str(tmp_path / "ckpt")
    shutil.copytree(FIXTURE, path)
    db = ocdbt.Database(path)
    node = os.path.join(path, db.root.path)
    data = bytearray(open(node, "rb").read())
    data[db.root.offset + 20] ^= 0x10
    open(node, "wb").write(bytes(data))
    with pytest.raises(ocdbt.CorruptError, match="CRC-32C"):
        orbax_state.restore_raw(path)
