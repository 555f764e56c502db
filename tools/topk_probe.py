#!/usr/bin/env python3
"""Where the time of K3's 128-query (``wgmma``) block goes: full A
(Q=1024 over 1,048,576 rows at D=64, k=8) timed through builds of
``csrc/similarity_topk.cu`` with parts of ``topk_wide_kernel`` cut out.

    python3 tools/topk_probe.py [--source FILE]

Variants: ``base``; ``no_select`` (every ``select_tile`` call in the
kernel skipped: scores are computed and handed over, never selected);
``no_split`` (the corpus chunks' TF32 split skipped: the products read
raw fp32 bits); ``no_select_no_split``.  A cut build's answers are
wrong: it exists only to be timed.  ``--source`` probes another version
of the file (say, a parent commit's, from ``git show``); the cut sources
and their libraries go to ``src/repro_torch/kernels/_build/probe/``
(gitignored).  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import re
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
VARIANTS = {"base": (), "no_select": ("NO_SELECT",),
            "no_split": ("NO_SPLIT",),
            "no_select_no_split": ("NO_SELECT", "NO_SPLIT")}
SHAPE = (1024, 1 << 20, 64, 8)      # full A: Q, N, D, k


def cut(source: str) -> str:
    """``source`` with topk_wide_kernel's select_tile and split_run calls
    each under ``#ifndef PROBE_NO_SELECT`` / ``PROBE_NO_SPLIT``."""
    start = source.index("topk_wide_kernel(")
    end = source.index("\n}\n", start)
    body = source[start:end]
    counts = {}
    for fn, macro in (("select_tile", "NO_SELECT"), ("split_run", "NO_SPLIT")):
        body, n = re.subn(rf"(\n[ \t]*{fn}\b[^;]*;)",
                          rf"\n#ifndef PROBE_{macro}\1\n#endif", body)
        counts[fn] = n
    if not all(counts.values()):
        raise SystemExit(f"topk_probe: no call to cut in {counts}")
    return source[:start] + body + source[end:]


def variant_ops(name: str, path: Path):
    """A copy of the K3 wrapper bound to the library built from ``path``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.similarity_topk import ops
    spec = importlib.util.spec_from_file_location(
        f"topk_probe_{name}", KERNELS / "similarity_topk" / "ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LIB = build.CudaLibrary(path.resolve(), ops.LIB.signatures)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path,
                    default=KERNELS / "csrc" / "similarity_topk.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("topk_probe: no CUDA device", file=sys.stderr)
        return 2
    print(smoke.card_line())
    text = cut(args.source.read_text())
    out = KERNELS / "_build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    mods = {}
    for name, macros in VARIANTS.items():
        path = out / f"similarity_topk_{name}.cu"
        path.write_text("".join(f"#define PROBE_{m} 1\n" for m in macros)
                        + text)
        mods[name] = variant_ops(name, path)
    smoke.build_kernels(*[types.SimpleNamespace(LIB=m.LIB)
                          for m in mods.values()])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 5)
    Q, N, D, k = SHAPE
    q, c = (mods["base"].l2_normalize(torch.randn(s, generator=gen,
                                                  device=dev))
            for s in ((Q, D), (N, D)))
    for name, mod in mods.items():
        t = [smoke.cuda_time_ms(lambda: mod.similarity_topk_cuda(q, c, k),
                                10) for _ in range(3)]
        print(f"probe {args.source.name} Q={Q} N={N} D={D} k={k} {name}: "
              f"{sum(t) / len(t):.4f} ms (turns "
              f"{', '.join(f'{x:.4f}' for x in t)})")
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
