"""Models: ViT towers, projector, splice, LLaMA decoder, LLaVA."""
