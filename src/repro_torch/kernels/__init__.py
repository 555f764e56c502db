"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Sources live in ``csrc/``; ``build`` compiles them with nvcc at
first use and binds them through ctypes.

A launch through ctypes is invisible to a PyTorch dispatch mode, so each
wrapper reports the work of its launch to :data:`WORK_HOOK` when one is
installed (``launch/op_cost.py`` installs it while it counts a step)."""
from typing import Callable, Optional

# called as WORK_HOOK(kernel name, flops, bytes) at each launch, or None
WORK_HOOK: Optional[Callable[[str, float, float], None]] = None


def report(name: str, work: Callable[[], tuple]) -> None:
    """Hand ``work()`` -> (flops, bytes) of one launch to the hook, if any
    (``work`` runs only then: it may read the data).  The ops ``work``
    runs are outside every dispatch mode: counting them is no work of the
    step."""
    if WORK_HOOK is not None:
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            flops, nbytes = work()
        WORK_HOOK(name, float(flops), float(nbytes))
