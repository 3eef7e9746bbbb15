"""Attention ops: plain PyTorch references and the hand-written CUDA
kernels (built from ../csrc by _build)."""
