#!/usr/bin/env python3
"""Where the time of K5's chunked path goes: the full shape (B=8, S=384,
32 heads of 64) and rwkv6-1.6b's largest served pass (S=128) timed
through builds of ``csrc/rwkv6_scan.cu`` with phases of
``rwkv6_chunk_kernel`` cut out.

    python3 tools/scan_probe.py [--source FILE]

Variants: ``base``; ``no_scores`` (phase 3, the score matrix A, skipped);
``no_outputs`` (phase 4, O = rq S0 + A V, skipped); ``no_state`` (phase
5, the state update, skipped); ``factors_only`` (phases 3-5 skipped:
what is left is loading the inputs and forming the decay factors, the
barriers and the launch).  A cut build's answers are wrong: it exists
only to be timed, in event time (``cuda_time_ms``, 50 calls, three
turns) and device time (the profiler).  ``--source`` probes another
version of the file; the cut sources and their libraries go to
``src/repro_torch/kernels/_build/probe/`` (gitignored).  Needs a CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
# the text that starts each phase, and what it becomes when cut
PHASES = {
    "scores": [("if (tid < OFF_TILES) {", "if (false) {"),
               ("} else if (tid < OFF_TILES + DIAG) {",
                "} else if (false) {")],
    "outputs": [("unit < (C / 16) * (HD / 16);", "unit < 0;")],
    "state": [("unit < (HD / 16) * (HD / 16);", "unit < 0;")],
}
VARIANTS = {"base": (), "no_scores": ("scores",),
            "no_outputs": ("outputs",), "no_state": ("state",),
            "factors_only": ("scores", "outputs", "state")}
SHAPES = [("full", 8, 384, 32, 64), ("served", 8, 128, 32, 64)]


def cut(source: str, phases) -> str:
    for phase in phases:
        for old, new in PHASES[phase]:
            if source.count(old) != 1:
                raise SystemExit(f"scan_probe: {old!r} is not in the source "
                                 "exactly once")
            source = source.replace(old, new)
    return source


def variant_ops(name: str, path: Path):
    """A copy of the K5 wrapper bound to the library built from ``path``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6_scan import ops
    spec = importlib.util.spec_from_file_location(
        f"scan_probe_{name}", KERNELS / "rwkv6_scan" / "ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LIB = build.CudaLibrary(path.resolve(), ops.LIB.signatures)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path,
                    default=KERNELS / "csrc" / "rwkv6_scan.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 2
    print(smoke.card_line())
    text = args.source.read_text()
    out = KERNELS / "_build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    mods = {}
    for name, phases in VARIANTS.items():
        path = out / f"rwkv6_scan_{name}.cu"
        path.write_text(cut(text, phases))
        mods[name] = variant_ops(name, path)
    smoke.build_kernels(*[types.SimpleNamespace(LIB=m.LIB)
                          for m in mods.values()])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 8)
    for what, B, S, H, hd in SHAPES:
        r, k, v = (torch.randn((B, S, H, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        w = smoke.decays(torch, gen, (B, S, H, hd), dev)
        u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
        s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev)
        for name, mod in mods.items():
            def fn():
                return mod.rwkv6_scan_cuda(r, k, v, w, u, s0)
            t = [smoke.cuda_time_ms(fn, 50) for _ in range(3)]
            print(f"probe {args.source.name} {what} B={B} S={S} H={H} "
                  f"hd={hd} {name}: {sum(t) / len(t):.4f} ms (turns "
                  f"{', '.join(f'{x:.4f}' for x in t)}), device "
                  f"{smoke.fmt_ms(smoke.device_ms(fn))}")
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
