"""Batched cosine-similarity top-k: the semantic index's scoring kernel (K3)."""
