"""Writes the orbax fixture that tests/test_torch_orbax.py and
`chip_smoke.py` phase 19 (d) read: `tests/data/orbax_tiny/checkpoint-1`, a
train state saved by the JAX package's `save_train_state` from 4 host
devices (its 2-d leaves sharded by rows, so several zarr chunks an array),
and `tests/data/orbax_tiny_arrays.npz`, the same state's arrays as a
`param_io` file.

The state: the JAX `build_model` of `FIXTURE_CONFIG` (the tiny LLaVA at one
decoder layer, fp32), an int32 `step` scalar and `extra` bf16 and int8
leaves.

    python tests/make_orbax_fixture.py
"""

import os
import shutil
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from law_of_vision_representation_in_mllms_tpu.core.config import (  # noqa: E402
    RunConfig)
from law_of_vision_representation_in_mllms_tpu.io import (  # noqa: E402
    checkpoint as jckpt, param_io)
from law_of_vision_representation_in_mllms_tpu.train import (  # noqa: E402
    runner as jrunner)

HERE = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(HERE, "data", "orbax_tiny")
ARRAYS = os.path.join(HERE, "data", "orbax_tiny_arrays.npz")
FIXTURE_CONFIG = {"model": {"decoder": "tiny",
                            "vision_tower": "debug/tiny-vit",
                            "decoder_layers": 1},
                  "train": {"bf16": False, "seed": 0}}


def fixture_state():
    _, params = jrunner.build_model(RunConfig.from_dict(FIXTURE_CONFIG))
    rng = np.random.RandomState(0)
    return {"params": params, "step": jnp.asarray(7, jnp.int32),
            "extra": {"bf16": jnp.asarray(rng.randn(48, 64), jnp.bfloat16),
                      "int8": jnp.asarray(rng.randint(-7, 8, (64, 40)),
                                          jnp.int8)}}


def shard(state, devices):
    """Leaves whose first dim 4 divides, split by rows over 4 devices; the
    rest replicated."""
    mesh = Mesh(np.asarray(devices[:4]), ("x",))

    def place(x):
        spec = P("x") if x.ndim >= 2 and x.shape[0] % 4 == 0 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(place, state)


def main():
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    state = shard(fixture_state(), jax.devices())
    jckpt.save_train_state(RUN_DIR, state, 1)
    param_io.save_params(ARRAYS, jax.tree.map(np.asarray, state))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(RUN_DIR) for f in fs)
    print(f"{RUN_DIR}: {total} bytes; {ARRAYS}: "
          f"{os.path.getsize(ARRAYS)} bytes")


if __name__ == "__main__":
    main()
