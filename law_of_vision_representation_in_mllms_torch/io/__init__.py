"""Parameter files: the flat .npz reader and the JAX-tree converter."""
