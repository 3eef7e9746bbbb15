"""PyTorch/CUDA port of law_of_vision_representation_in_mllms_tpu for the
NVIDIA H100: the LLaVA-1.5 serving path with hand-written Hopper kernels.
The JAX package beside it is the reference this package is held against."""
