"""PyTorch / CUDA port of the AISQL serving engine's model path.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points run on a CUDA device unless the caller passes
``device="cpu"``; attention runs through the hand-written kernels in
``repro_torch.kernels`` on the card and through their plain PyTorch
versions on the CPU.
"""
