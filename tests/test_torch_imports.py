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
        optional = [m for m in ("PIL", "yaml", "transformers",
                                "safetensors", "diffusers", "sympy")
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
                "io.from_jax", "eval.llava_adapter", "train.runner",
                "ops.a_score", "metrics.a_score", "pipeline.a_score_run",
                "eval.evaluator", "eval.task", "eval.metrics", "eval.tasks",
                "eval.tasks.paper_tasks", "eval.runner", "policy",
                "policy.fit", "policy.data", "policy.predict",
                "policy.validate", "ops.quant", "ops.int4_matmul",
                "models.layers", "models.mpt", "models.lora",
                "models.switch", "models.diffusion_blocks", "models.vae",
                "models.unet", "models.featurizer", "models.tower_runtime",
                "io.featurizer_bundle", "io.port_cli", "io.hf_port",
                "io.diffusers_port", "models.text_encoder",
                "core.representations", "eval.judge",
                "eval.math_equivalence", "eval.models_registry",
                "eval.hf_adapters", "eval.tasks.judged_tasks",
                "eval.tasks.grounding_tasks", "eval.tasks.mathvista_tasks",
                "eval.tasks.extra_tasks"):
        assert f"{PKG}.{mod}" in out["names"]


def test_porting_a_snapshot_loads_no_jax_and_no_hf_package(tmp_path):
    """`port_cli` on a CLIP text snapshot and `port_featurizer_bundle` on a
    tiny SD1.5 root (both written here with `safetensors` and
    `transformers`) run in a fresh interpreter that never loads JAX, the
    JAX package, `safetensors`, `transformers` or `diffusers`."""
    import test_torch_port_featurizer as PF
    from law_of_vision_representation_in_mllms_torch.models import (
        featurizer as TF)
    root = PF.snapshot_root(str(tmp_path / "snap"), "sd15")
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(TF.config_to_dict(PF.CONFIGS["sd15"]), f)
    out = _run(f"""
        import json, sys
        from {PKG}.io import featurizer_bundle as FB, port_cli
        from {PKG}.models import featurizer as F
        port_cli.main(["clip_text", "{root}/text_encoder",
                       "{tmp_path}/text.npz", "--penultimate"])
        with open("{tmp_path}/cfg.json") as f:
            cfg = F.config_from_dict(json.load(f))
        path = FB.port_featurizer_bundle("sd15", "{root}",
                                         "{tmp_path}/bundle", config=cfg,
                                         device="cpu")
        tree, _ = FB.load_featurizer_bundle(path)
        loaded = [m for m in sys.modules if m.split(".")[0] in (
            "jax", "flax", "optax", "orbax", "{TPU}", "safetensors",
            "transformers", "diffusers")]
        print(json.dumps({{"loaded": loaded,
                          "prompt": list(tree["prompt_embeds"].shape)}}))
    """)
    assert out == {"loaded": [], "prompt": [1, 77, 16]}


def test_cli_tasks_runs_without_jax():
    """`lvr-torch tasks` lists the 44 bundled tasks (the paper's 11 among
    them) and loads no JAX."""
    out = _run(f"""
        import contextlib, io, json, sys
        from {PKG} import cli
        from {PKG}.eval.tasks import PAPER_TASKS
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["tasks", "--device", "cpu"])
        listed = [line.split()[0] for line in buf.getvalue().splitlines()]
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                         "{TPU}")]
        print(json.dumps({{"rc": rc, "listed": listed,
                          "paper": sorted(PAPER_TASKS), "loaded": loaded}}))
    """)
    assert out["rc"] == 0
    assert len(out["listed"]) == 44 and out["listed"] == sorted(
        out["listed"])
    assert set(out["paper"]) < set(out["listed"])
    assert out["loaded"] == []


def test_no_port_source_names_a_jax_import():
    """No module of the port and no line of chip_smoke.py imports JAX, Flax,
    Optax, Orbax or the JAX package (a static check beside the runtime
    one, which also covers lazy imports inside functions)."""
    import re
    pattern = re.compile(
        rf"^\s*(import|from)\s+(jax|flax|optax|orbax|{TPU})\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PKG)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        assert not pattern.search(open(path).read()), path


@pytest.mark.parametrize("op", ["encoder", "flash", "decode", "a_score",
                                "decode_int8", "int4", "flash_alibi"])
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
                                                decode_attention_int8,
                                                decode_attention_plain)
        from {PKG}.ops.int4_matmul import (int4_matmul_kernel,
                                           int4_matmul_plain)
        from {PKG}.ops.quant import quantize_int4, quantize_kv
        from {PKG}.ops.a_score import a_score_plain, max_cos
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
        elif "{op}" == "flash_alibi":
            from {PKG}.models.mpt import alibi_slopes
            wrapper = flash_attention
            sl = alibi_slopes(4)
            same = torch.equal(
                flash_attention(q, kv, kv, causal=True, alibi_slopes=sl),
                flash_attention_plain(q, kv, kv, causal=True,
                                      alibi_slopes=sl))
            same = same and flash_attention.alibi_launches == 0
        elif "{op}" == "decode":
            wrapper = decode_attention
            same = torch.equal(decode_attention(q[:, :1], kv, kv, mask),
                               decode_attention_plain(q[:, :1], kv, kv, mask))
        elif "{op}" == "decode_int8":
            wrapper = decode_attention_int8
            (kc, ks), (vc, vs) = quantize_kv(kv), quantize_kv(kv + 1)
            same = torch.equal(
                decode_attention(q[:, :1], kc, vc, mask, ks, vs),
                decode_attention_plain(q[:, :1], kc, vc, mask, ks, vs))
            same = same and decode_attention.launches == 0
        elif "{op}" == "int4":
            wrapper = int4_matmul_kernel
            leaf = quantize_int4(torch.randn(16, 256, generator=g))
            x = torch.randn(3, 256, generator=g)
            same = torch.equal(
                int4_matmul_kernel(x, leaf["q4"], leaf["scale"]),
                int4_matmul_plain(x, leaf["q4"], leaf["scale"]))
        else:
            wrapper = max_cos
            t, a = q[:, :, 0], kv[:, :12, 0]
            same = torch.equal(max_cos(t, a, mask, mask[:, :12]),
                               a_score_plain(t, a, mask, mask[:, :12]))
        print(json.dumps({{"same": same, "launches": wrapper.launches,
                          "built": _build.library.cache_info().currsize,
                          "jax": "jax" in sys.modules}}))
    """)
    assert out == {"same": True, "launches": 0, "built": 0, "jax": False}
