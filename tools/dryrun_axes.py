"""The dry-run's records of the three production meshes, cell by cell:
``benchmarks.report_roofline``'s columns for (data 32, model 8), the
bytes a card holds (peak, GiB) on every mesh, and the wire bytes a step
moves on each mesh axis (GB) at model 8 against model 16, with the
collective time ``launch/roofline`` charges them (NVLink inside a node,
InfiniBand across).

    PYTHONPATH=src python tools/dryrun_axes.py \\
        results_torch/dryrun_h100.json results_torch/dryrun_h100_model16.json

The first file holds the model-8 records of both meshes, the second the
model-16 single-pod ones.  Prints one markdown table.
"""
from __future__ import annotations

import json
import sys


def _records(path):
    with open(path) as f:
        recs = json.load(f)
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs
            if r.get("ok") and not r.get("skipped")}


def _axes(r) -> str:
    by = (r.get("detail") or {}).get("collective_by_axis") or {}
    return " ".join(f"{a[0]}{b / 1e9:.0f}" for a, b in sorted(by.items())
                    if b >= 5e8) or "<1"


def _gib(r) -> str:
    if r is None:
        return "-"
    m = r["memory_per_device"]
    return f"{m['peak_bytes'] / 2**30:.1f}{'' if m['fits'] else '!'}"


def main(argv) -> int:
    recs = _records(argv[1])
    recs.update(_records(argv[2]))
    cells = sorted({(a, s) for a, s, m in recs if m == "32x8"})
    print("| arch | shape | C / M / X ms | bound | useful | MFU | peak GiB "
          "32x8, 2x32x8, 16x16 | X ms 2x32x8, 16x16 | wire GB 32x8 | "
          "wire GB 16x16 |")
    print("|---|---|---:|---|---:|---:|---|---|---|---|")
    for a, s in cells:
        r = recs[(a, s, "32x8")]
        mp, m16 = recs.get((a, s, "2x32x8")), recs.get((a, s, "16x16"))
        xs = " / ".join("-" if x is None else
                        f"{x['t_collective_s'] * 1e3:.0f}" for x in (mp, m16))
        print(f"| {a} | {s} | {r['t_compute_s'] * 1e3:.1f} / "
              f"{r['t_memory_s'] * 1e3:.1f} / "
              f"{r['t_collective_s'] * 1e3:.1f} | {r['bottleneck']} | "
              f"{r['useful_flop_ratio']:.1%} | {r['mfu_bound']:.2%} | "
              f"{_gib(r)}, {_gib(mp)}, {_gib(m16)} | {xs} | {_axes(r)} | "
              f"{'-' if m16 is None else _axes(m16)} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
