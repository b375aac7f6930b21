"""Numpy-only checkpoint mappings carried over from the JAX package."""
