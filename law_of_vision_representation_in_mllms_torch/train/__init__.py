"""The parts of the training runner that build a model and tokenizer."""
