"""Eval surface: the LMM adapter and build_lmm."""
