#!/usr/bin/env python3
"""Is host-bound engine work slower on a worker thread than on the main
thread?  The HTTP service runs every query on a ``ServingEngine`` worker
thread; ``chip_smoke.py``'s in-process AISQL run uses the main thread.

    python3 tools/thread_probe.py

proxy-8b at full width (random bf16 weights from ``chip_smoke.SEED``)
serves one batch of 8 COMPLETEs of 32 tokens and 8 SCOREs, in turns on
the main thread and on one persistent worker thread fed through a queue,
as ``ServingEngine``'s workers are (main, worker, worker, main, ...; 8
turns each after one warm-up on each thread).  Prints each thread's
batch times and the ratio of the medians.  Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import queue
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

TURNS = 8


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("thread_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.inference.backend import COMPLETE, SCORE, Request
    from repro_torch.inference.engine import TorchInferenceEngine
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    print(cs.card_line())
    cs.build_kernels(dec_ops, flash_ops)
    eng = TorchInferenceEngine("proxy-8b", smoke=False, seed=cs.SEED)
    reqs = [Request(p, "proxy-8b", COMPLETE, max_tokens=32, request_id=i)
            for i, p in enumerate(cs.PROMPTS_COMPLETE * 2)]
    reqs += [Request(p, "proxy-8b", SCORE, request_id=100 + i)
             for i, p in enumerate(cs.PROMPTS_SCORE)]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit_batch(reqs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    jobs, done = queue.Queue(), queue.Queue()

    def worker():
        while (fn := jobs.get()) is not None:
            done.put(fn())
    th = threading.Thread(target=worker, name="aisql-serve-0", daemon=True)
    th.start()

    def on_worker():
        jobs.put(run)
        return done.get()
    run()
    on_worker()                       # warm both threads
    times = {"main": [], "worker": []}
    for i in range(TURNS):
        for k in (("main", "worker") if i % 2 == 0 else ("worker", "main")):
            times[k].append(run() if k == "main" else on_worker())
    jobs.put(None)
    th.join(timeout=60)
    for k, v in times.items():
        print(f"{k}: median {statistics.median(v):.4f} s, runs "
              f"{[round(x, 4) for x in v]}")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"worker / main medians {med['worker'] / med['main']:.3f}; torch "
          f"threads {torch.get_num_threads()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
