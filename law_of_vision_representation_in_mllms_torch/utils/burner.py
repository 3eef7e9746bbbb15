"""Card burn-in / keep-busy loop (counterpart of the JAX package's
`utils/burner.py`; the reference ships a DataParallel CIFAR burner,
`gpu.py:1-62`, that loops to keep GPUs warm).

A chain of 8 bf16 products of a [size, size] matrix, repeated for `seconds`;
the card is synchronised before the clock is read, so the TFLOP/s printed
are sustained, not queued. A plain large product, so it stays
`torch.matmul`. Runs on the card unless `device` says otherwise:

    python -m law_of_vision_representation_in_mllms_torch.utils.burner \
        --seconds 60 --size 4096 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

CHAIN = 8


def burn(seconds: float = 60.0, size: int = 4096, device="cuda",
         report_every: float = 5.0) -> float:
    """Run chains for `seconds`; returns the sustained TFLOP/s (2 size^3
    operations a product, `CHAIN` products a chain)."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to burn the "
                           "CPU")
    dtype = torch.bfloat16
    x = torch.ones((size, size), dtype=dtype, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = last = time.perf_counter()
    n = 0
    while True:
        # a scale that changes every chain, so no chain repeats the last
        y = x
        for _ in range(CHAIN):
            y = torch.matmul(y, x) * (1.0 + 1e-6 * n)
        n += 1
        sync()
        now = time.perf_counter()
        tflops = CHAIN * 2 * size ** 3 * n / (now - t0) / 1e12
        if now - last > report_every:
            print(f"burner: {n} chains, {tflops:.1f} TFLOP/s sustained")
            last = now
        if now - t0 >= seconds:
            print(f"burner: {n} chains in {now - t0:.2f} s, {tflops:.1f} "
                  f"TFLOP/s sustained ({size}x{size} bf16 on {device})")
            return tflops


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    burn(a.seconds, a.size, a.device)
