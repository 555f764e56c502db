"""Run one cell of the benchmark once and print its result line.

    python3 aisqlbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line on standard output is the result, a JSON object; the
last lines on standard error are the numbers the check compared, each
beside its limit.  Exits 2, printing no result, without CUDA, without
enough cards, or without the program (``src/repro_torch``) beside it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def fail(msg: str) -> int:
    print(f"aisqlbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / "_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(HERE / "_cache" / "torch_extensions"))
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("the program (src/repro_torch) is not beside the "
                    "benchmark")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    from aisqlbench import harness, spec
    bench = spec.Bench()
    chips = bench.workload(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} present")
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded in this process: {', '.join(bad)}")
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
