"""PyTorch / CUDA port of the AISQL serving engine's model path, the
client stack in front of it, the semantic index and the training path.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points run on a CUDA device unless the caller passes
``device="cpu"``; attention and the index's similarity top-k run through
the hand-written kernels in ``repro_torch.kernels`` on the card and
through their plain PyTorch versions on the CPU.
"""
