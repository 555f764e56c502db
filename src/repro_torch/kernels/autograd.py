"""Gradients through the hand-written kernels.

The JAX package differentiates its plain attention and ``lax.scan``
recurrences, never a Pallas kernel.  K2's and K5's
``torch.autograd.Function`` launch the kernel in their forward and, in
their backward, recompute the plain version (``ref.py``) from the saved
inputs with the forward's arguments and differentiate that: the gradient
is the plain version's.  K4's backward is the kernel run in reverse
(``rglru_scan/ops.py``), which gives the same bits.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def recompute_grads(plain: Callable, inputs: Sequence[torch.Tensor],
                    needs: Sequence[bool], grads: Sequence[torch.Tensor]
                    ) -> Tuple:
    """Gradients of ``plain(*inputs)`` (a tuple of outputs) against
    ``grads`` of its outputs, for the inputs whose ``needs`` is set (None
    for the others)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = plain(*leaves)
        wrt = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
    return tuple(next(got) if n else None for n in needs)
