"""The PyTorch port imports no JAX, Flax, Optax or Orbax, and its kernel
wrappers run their plain versions for CPU tensors without counting a launch.

Each check runs in a fresh interpreter: the test process itself has JAX
loaded (tests/conftest.py imports it).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "law_of_vision_representation_in_mllms_torch"
TPU = "law_of_vision_representation_in_mllms_tpu"


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_port_module_imports_without_jax():
    out = _run(f"""
        import importlib, json, pkgutil, sys
        import {PKG} as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                        "{PKG}.")]
        for name in names:
            importlib.import_module(name)
        frameworks = [m for m in ("jax", "flax", "optax", "orbax")
                      if m in sys.modules]
        # host-side packages the card machine may lack stay unloaded
        optional = [m for m in ("PIL", "yaml", "transformers")
                    if m in sys.modules]
        tpu = [m for m in sys.modules if m.startswith("{TPU}")]
        print(json.dumps({{"names": names, "frameworks": frameworks,
                          "optional": optional, "tpu": tpu}}))
    """)
    assert out["frameworks"] == []
    assert out["optional"] == []
    assert out["tpu"] == []
    for mod in ("cli", "models.llava", "ops.encoder_attention",
                "ops.flash_attention", "ops.decode_attention", "ops._build",
                "io.from_jax", "eval.llava_adapter", "train.runner"):
        assert f"{PKG}.{mod}" in out["names"]


@pytest.mark.parametrize("op", ["encoder", "flash", "decode"])
def test_wrappers_take_plain_path_on_cpu(op):
    out = _run(f"""
        import json, sys
        import torch
        from {PKG}.ops import _build
        from {PKG}.ops.encoder_attention import (encoder_attention,
                                                 encoder_attention_plain)
        from {PKG}.ops.flash_attention import (flash_attention,
                                               flash_attention_plain)
        from {PKG}.ops.decode_attention import (decode_attention,
                                                decode_attention_plain)
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 20, 4, 8, generator=g)
        kv = torch.randn(2, 20, 2, 8, generator=g)
        mask = torch.rand(2, 20, generator=g) < 0.5
        mask[:, 0] = True
        if "{op}" == "encoder":
            wrapper = encoder_attention
            same = torch.equal(encoder_attention(q, q, q),
                               encoder_attention_plain(q, q, q))
        elif "{op}" == "flash":
            wrapper = flash_attention
            same = torch.equal(
                flash_attention(q, kv, kv, causal=True, kv_len=15),
                flash_attention_plain(q, kv, kv, causal=True, kv_len=15))
        else:
            wrapper = decode_attention
            same = torch.equal(decode_attention(q[:, :1], kv, kv, mask),
                               decode_attention_plain(q[:, :1], kv, kv, mask))
        print(json.dumps({{"same": same, "launches": wrapper.launches,
                          "built": _build.library.cache_info().currsize,
                          "jax": "jax" in sys.modules}}))
    """)
    assert out == {"same": True, "launches": 0, "built": 0, "jax": False}
