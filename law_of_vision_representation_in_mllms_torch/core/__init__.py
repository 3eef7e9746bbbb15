"""Precision policy and run config."""
