"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``.cu`` file exports a plain C interface and becomes one shared
library, compiled for ``sm_90a`` at first use into ``_build/`` beside this
file (listed in ``.gitignore``), named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time: this module imports on a host without
CUDA, where only the plain PyTorch versions of the kernels are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# dtype codes understood by the C entry points (csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


class CudaLibrary:
    """One ``.cu`` source compiled to a shared library, loaded once.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every exported function returns the ``cudaError_t`` of its
    launch.
    """

    def __init__(self, source: str, signatures: Dict[str, Sequence]):
        self.source = CSRC / source
        self.signatures = dict(signatures)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""
        self.build_seconds = 0.0

    def _inputs(self) -> List[Path]:
        return [self.source] + sorted(CSRC.glob("*.cuh"))

    def target(self) -> Path:
        h = hashlib.sha256()
        for p in self._inputs():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def compile_command(self, out: Path) -> List[str]:
        return [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, f"-I{CSRC}",
                "-o", str(out), str(self.source)]

    def load(self) -> ctypes.CDLL:
        """Build the library if it is not built yet, then load it once.
        Libraries of different sources may load from several threads at
        once, so their nvcc runs overlap."""
        with self._lock:
            if self._lib is None:
                out = self.target()
                if not out.exists():
                    self._build(out)
                lib = ctypes.CDLL(str(out))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def _build(self, out: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(self.compile_command(tmp),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)           # atomic: concurrent builders agree


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an int, without building a
    ``torch.cuda.Stream`` (the served launches are bound by the host)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
