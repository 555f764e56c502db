"""Flash-decode: one new token per sequence against a KV cache."""
