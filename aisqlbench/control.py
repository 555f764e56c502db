"""Readings that set a cell's limits: the program's numbers over many seeds
and the control's (the reference in fp8) over a few, in one process.

    python3 aisqlbench/control.py --workload <name> --seconds <s> \
        --seeds 1,2,...,12 --control 1,2,3 [--out FILE]

For each seed the program is served as a run serves it (its weights made
again from that seed, its traffic, warm-up, a window of the cell's own
load) and its answers are kept; then the program is freed and the
reference judges each seed's answers, and the control's own answers on the
``--control`` seeds.  Prints one JSON line a seed.  The benchmark's runs
do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(workload, seeds, control, seconds, *, device="cuda",
             smoke=False, bench=None, log=sys.stderr):
    from aisqlbench import harness, spec
    bench = bench or spec.Bench()
    st = harness.Setup(bench, workload, device=device, smoke=smoke,
                       trace=False, limits={})
    kept = {}
    for seed in seeds:
        tr, recs, _, setup_s, _ = st.serve(seed, seconds, time.perf_counter(),
                                           profile=False)
        kept[seed] = (st.outputs(tr, recs, seed),
                      sum(not r["ok"] for r in recs))
        print(f"seed {seed}: {len(recs)} queries, {len(kept[seed][0])} rows "
              f"sampled", file=log)
    arch, model, tie = st.arch, st.model, st.tie
    st.free()
    out = []
    for seed in seeds:
        rows, failed = kept[seed]
        line = {"seed": seed, "failed": failed, "program": harness.check(
            rows, arch, model, seed, st.device, tie)}
        if seed in control:
            line["control"] = harness.check(rows, arch, model, seed,
                                            st.device, tie, precision="fp8")
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("aisqlbench: CUDA is not available", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control.split(",") if s}
    readings(args.workload, seeds, control, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
