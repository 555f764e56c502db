"""One run of one cell: set-up, warm-up, the measured window, the check
of what the window produced against the plain reference, and the metrics.

The window drives ``ServingEngine.submit(tenant, sql)``: the path an AISQL
user's query takes (SQL layer, ``CortexClient``, the shared
``RequestPipeline``, ``Scheduler``, ``submit_batch``, the continuous
batcher, the model, the card).  From the program the harness takes the
system under test and what it can observe of it:

* the engine's ``submit_batch`` (a wrapper times each dispatch and keeps
  each SCORE it returns);
* the continuous batcher's ``_prefill_step`` (a wrapper times the steps
  and reads its token counter).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from aisqlbench import devtrace, judge, spec, timeline, tokens, traffic
from aisqlbench import weights

# how long after the close a query submitted in the window may still
# return: the drain is part of the measurement, and a query lasts until
# its longest row
GRACE_S = 180.0
# a traced run records the device over the window's first TRACE_S seconds
# (reading the profiler's events takes seconds for each traced second, and
# a run has 360 s)
TRACE_S = 20.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program, built from a configuration file
# ---------------------------------------------------------------------------


ABSENT = "<no such field>"


def _plain(v: Any) -> Any:
    """A value of the port's configuration as a JSON file holds it."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return v


def model_dict(cfg, like: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of ``like`` (a configuration file's ``model`` section),
    nested sections too, read off the port's ``ModelConfig``: a section
    such as ``"moe"`` off ``cfg.moe`` field by field (how a smoke model is
    described to the reference)."""
    out = {}
    for k, want in like.items():
        got = getattr(cfg, k, ABSENT)
        if isinstance(want, dict) and dataclasses.is_dataclass(got):
            out[k] = model_dict(got, want)
        else:
            out[k] = _plain(got)
    return out


def _departures(want: Dict[str, Any], got: Dict[str, Any],
                prefix: str = "") -> List[str]:
    out = []
    for k, v in want.items():
        g = got[k]
        if isinstance(v, dict) and isinstance(g, dict):
            out += _departures(v, g, f"{prefix}{k}.")
        elif g != v:
            out.append(f"{prefix}{k}: file {v!r}, program {g!r}")
    return out


def check_config(cfg, model: Dict[str, Any]) -> List[str]:
    """Where the port's configuration departs from the file's, key by key
    (``moe.num_experts_per_tok``)."""
    return _departures(model, model_dict(cfg, model))


def build_engine(conf: Dict[str, Any], device: str, smoke: bool):
    """The engine of the configuration's model, and the ``model`` section
    the reference is given: the file's, checked against the port's
    configuration; with ``smoke``, the same keys read off the smoke
    model, served in the file's type."""
    from repro_torch.configs import base
    from repro_torch.inference.engine import TorchInferenceEngine
    e, file_model = conf["engine"], conf["model"]
    which = conf["model_id"]
    if smoke:
        which = dataclasses.replace(base.get_smoke_config(which),
                                    dtype=file_model["dtype"])
    eng = TorchInferenceEngine(which, smoke=smoke,
                               max_batch=e["slots"], max_seq=e["max_seq"],
                               backend="continuous", device=device)
    if smoke:
        return eng, model_dict(eng.cfg, file_model)
    bad = check_config(eng.cfg, file_model)
    if bad:
        raise SystemExit("aisqlbench: the program's configuration is "
                         "not the file's: " + "; ".join(bad))
    return eng, file_model


def fill_weights(params, arch, model: Dict[str, Any], seed: int,
                 device) -> None:
    """Write the seeded weights of ``arch`` (an ``archs/`` module) into the
    engine's parameters in place."""
    for group in arch.groups(model):
        for name, x in weights.draw(model, seed, group, device):
            node = params
            for part in name.split("."):
                node = node[int(part)] if part.isdigit() else node[part]
            if node.shape != x.shape or node.dtype != x.dtype:
                raise SystemExit(f"aisqlbench: parameter {name} is "
                                 f"{tuple(node.shape)} {node.dtype}, the "
                                 f"benchmark makes {tuple(x.shape)} {x.dtype}")
            node.copy_(x)
            del x


# ---------------------------------------------------------------------------
# taps on the timed path
# ---------------------------------------------------------------------------


class Taps:
    """Wrappers around the engine's dispatch and the batcher's prefill
    steps: host-side records only, and, when ``trace``, a synchronise at
    the end of each prefill step."""

    def __init__(self, eng, arch, model: Dict[str, Any], trace: bool):
        self.eng, self.arch, self.model, self.trace = eng, arch, model, trace
        self.b = eng._batcher
        self.lock = threading.Lock()
        self._undo = []
        self.on = False
        self.reset()
        self._wrap(eng, "submit_batch", self._submit_batch)
        self._wrap(self.b, "_prefill_step", self._prefill_step)

    def reset(self) -> None:
        self.dispatches: List[tuple] = []
        self.scores: Dict[str, float] = {}
        # (kind, t0, t1, tokens written, useful operations)
        self.steps: List[tuple] = []

    def _wrap(self, obj, name, fn) -> None:
        orig = getattr(obj, name)
        self._undo.append((obj, name, obj.__dict__.get(name, None)
                           if hasattr(obj, "__dict__") else None))
        setattr(obj, name, lambda *a, **k: fn(orig, *a, **k))

    def close(self) -> None:
        for obj, name, prev in reversed(self._undo):
            if prev is None:
                delattr(obj, name)
            else:
                setattr(obj, name, prev)
        self._undo = []

    # -- wrappers ----------------------------------------------------------
    def _submit_batch(self, orig, requests):
        t0 = time.perf_counter()
        out = orig(requests)
        t1 = time.perf_counter()
        if self.on:
            with self.lock:
                self.dispatches.append((t0, t1, len(requests)))
                for req, res in zip(requests, out):
                    if res.score is not None:
                        self.scores[req.prompt] = res.score
        return out

    def _prefill_step(self, orig, active, results, t0_):
        if self.on:
            ops = 0.0
            for s in active:
                if s is not None and s.state == "prefill":
                    n = min(self.b.prefill_chunk, len(s.enc) - s.filled)
                    ops += self.arch.step_flops(
                        self.model, s.filled, n,
                        int(s.filled + n == len(s.enc)))
        n0 = self.b.prefill_tokens
        t0 = time.perf_counter()
        orig(active, results, t0_)
        if self.trace and self.eng.device.type == "cuda":
            torch.cuda.synchronize()
        if self.on:
            self.steps.append(("prefill", t0, time.perf_counter(),
                               self.b.prefill_tokens - n0, ops))


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------


def _record(q, t_sub, ticket, deadline) -> Dict[str, Any]:
    rec = {"query": q, "tenant": q.tenant, "start": t_sub,
           "rows": len(q.ids), "ok": False, "end": None, "table": None,
           "error": None}
    try:
        rec["table"] = ticket.result(timeout=max(deadline - time.perf_counter(),
                                                 0.0))
        rec["ok"] = True
    except Exception as e:            # a failed query is a miss, kept
        rec["error"] = f"{type(e).__name__}: {e}"
    rec["end"] = time.perf_counter()
    return rec


def run_warmup(se, tr: traffic.Traffic) -> None:
    tickets = [se.submit(q.tenant, q.sql) for q in tr.warmup]
    for t in tickets:
        t.result(timeout=600)


def _run_at(t: float, fn, done=lambda: False) -> None:
    """Sleep until perf_counter time t (or ``done()``), then call fn."""
    while time.perf_counter() < t and not done():
        time.sleep(min(0.05, max(t - time.perf_counter(), 0.0)))
    fn()


def drive_closed(se, tr: traffic.Traffic, t0: float, seconds: float,
                 at=None) -> List[Dict]:
    """Each tenant a thread: submit, wait for the answer, submit the next,
    until ``seconds`` have passed; ``at`` = (time, fn): the calling thread
    runs fn then."""
    close = t0 + seconds
    out: List[Dict] = []
    lock = threading.Lock()
    errors: List[str] = []

    def tenant(name: str) -> None:
        pool = tr.pools[name]
        i = 0
        while time.perf_counter() < close:
            if i == len(pool):
                errors.append(f"{name} exhausted its {len(pool)} queries")
                return
            q = pool[i]
            i += 1
            t = time.perf_counter()
            rec = _record(q, t, se.submit(q.tenant, q.sql), close + GRACE_S)
            with lock:
                out.append(rec)

    threads = [threading.Thread(target=tenant, args=(n,), daemon=True)
               for n in tr.pools]
    for th in threads:
        th.start()
    if at is not None:
        _run_at(at[0], at[1],
                lambda: not any(th.is_alive() for th in threads))
    for th in threads:
        th.join()
    if errors:
        raise SystemExit("aisqlbench: the traffic pool is too small: "
                         + "; ".join(errors))
    return out


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def sample_rows(recs: List[Dict], tr: traffic.Traffic, n: int, seed: int,
                key) -> List[Dict]:
    """Up to n rows of the window's answered queries, drawn from the seed,
    the row with the largest ``key`` among them."""
    rows = []
    for rec in recs:
        if not rec["ok"]:
            continue
        q = rec["query"]
        for i, body in zip(q.ids, q.bodies):
            rows.append({"id": i, "prompt": tr.prompt_of(body), "rec": rec})
    if not rows:
        return []
    top = max(range(len(rows)), key=lambda j: key(rows[j]))
    rng = traffic.rng_for(seed, 2)
    rest = [j for j in rng.permutation(len(rows)).tolist() if j != top]
    return [rows[j] for j in [top] + rest[:n - 1]]


def collect_outputs(tr, recs, taps: Taps, n: int, seed: int) -> List[Dict]:
    """The program's answers for the sampled rows, off the device: whether
    the query kept the row, and the d of its SCORE."""
    rows = sample_rows(recs, tr, n, seed, key=lambda r: len(r["prompt"]))
    for r in rows:
        kept = {int(x) for x in r["rec"]["table"]["d.id"]}
        r["ids"] = tokens.encode(r["prompt"])
        r["kept"] = r["id"] in kept
        s = taps.scores.get(r["prompt"])
        r["d"] = judge.BIG if s is None else judge.logit_of(s)
        del r["rec"]
    return rows


def check(rows: List[Dict], arch, model: Dict, seed: int, device,
          tie: float, precision: str = "fp32") -> Dict[str, float]:
    """The numbers of ``judge`` for the sampled rows: the program's
    (``precision`` "fp32"), or the control's against the fp32 reference
    (``precision`` "fp8"), the reference being ``arch.Reference``; ``tie``
    as for ``judge.score_numbers``."""
    if not rows:                       # nothing answered: nothing proven
        return {"score_gap": judge.BIG}
    seqs = [r["ids"] for r in rows]
    pos = [[len(s) - 1] for s in seqs]
    lg = arch.Reference(model, seed, device).run(seqs, pos)
    if precision == "fp8":
        c_lg = arch.Reference(model, seed, device, "fp8").run(seqs, pos)
        rows = [dict(r, d=judge.d_of(c[-1])) for r, c in zip(rows, c_lg)]
    out = judge.score_numbers(rows, lg, tie)
    if precision == "fp8":
        del out["rows_wrong"]
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    workload: str
    conf: Dict[str, Any]
    model: Dict[str, Any]
    mix: Dict[str, Any]
    t0: float
    t1: float
    seconds: float
    queries: List[Dict]
    dispatches: List[tuple]
    steps: List[tuple]
    setup_s: float = 0.0
    events: Optional[list] = None       # (name, start ns, end ns), clipped
    window_ns: Optional[tuple] = None     # the traced window, profiler ns
    clock_window: Optional[tuple] = None  # the same, perf_counter seconds


class Setup:
    """The program built once, for one or several seeds (``control.py``
    reads a dozen seeds in one process)."""

    def __init__(self, bench: spec.Bench, workload: str, *, device: str,
                 smoke: bool, trace: bool, limits=None):
        self.bench = bench
        self.w = bench.workload(workload)
        self.name = workload
        self.conf = bench.config_file(self.w["config"])
        self.arch = bench.arch(self.w["config"])
        self.mix = bench.traffic_file(self.w["traffic"])
        self.cell = bench.cell_file(workload)
        self.limits = self.cell.get("limits", {}) if limits is None else limits
        # a row's decision may go either way within this of a tie: the
        # cell's ``tie``, else its score limit
        self.tie = self.cell.get("tie", self.limits.get("score_gap", 0.0))
        self.device = torch.device(device)
        self.trace = trace
        err = traffic.check_fits(self.mix, self.conf["engine"]["max_seq"])
        if err:
            raise SystemExit(f"aisqlbench: {workload}: {err}")
        self.t_built = time.perf_counter()
        self.eng, self.model = build_engine(self.conf, device, smoke)
        self.t_built = time.perf_counter() - self.t_built
        self.taps = Taps(self.eng, self.arch, self.model, trace)

    def serve(self, seed: int, seconds: float, t_start: float,
              profile: bool):
        """Weights and traffic from ``seed``, warm-up, then the window.
        Returns (traffic, records, Run fields, setup seconds, profiler)."""
        from repro_torch.core import Catalog, ExecConfig, ServingConfig
        from repro_torch.core import ServingEngine
        from repro_torch.inference.pipeline import PipelineConfig
        from repro_torch.inference.scheduler import Scheduler
        from repro_torch.obs import Observability
        from repro_torch.tables.table import Table
        t = time.perf_counter()
        fill_weights(self.eng.params, self.arch, self.model, seed,
                     self.device)
        t_w = time.perf_counter() - t
        tr = traffic.generate(self.mix, seed, seconds)
        catalog = Catalog({n: Table(c) for n, c in tr.tables.items()})
        sched = Scheduler()
        sched.register(self.eng)
        arch = self.eng.arch
        cfg = ServingConfig(
            workers=self.mix["workers"], default_model=arch, proxy_model=arch,
            executor=ExecConfig(use_cascade=False),
            pipeline=PipelineConfig(cache_ttl_s=300.0),
            obs=Observability(enabled=False))
        se = ServingEngine(catalog, sched, cfg=cfg, device=str(self.device))
        try:
            t = time.perf_counter()
            run_warmup(se, tr)
            print(f"set-up: engine {self.t_built:.2f} s, weights {t_w:.2f} s,"
                  f" warm-up {time.perf_counter() - t:.2f} s", file=sys.stderr)
            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize()
            self.taps.reset()
            self.taps.on = True
            prof, at, traced = None, None, []
            if profile:
                from torch.profiler import ProfilerActivity
                prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA])
                prof.__enter__()

                def stop():
                    traced.append(time.perf_counter())
                    prof.__exit__(None, None, None)
            clock = devtrace.HostClock()
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            if prof is not None:
                at = (t0 + min(seconds, TRACE_S), stop)
            recs = drive_closed(se, tr, t0, seconds, at)
            if cuda:
                torch.cuda.synchronize()
            t1 = max([r["end"] for r in recs] + [t0 + seconds])
            self.taps.on = False
        finally:
            se.close()
        return tr, recs, dict(t0=t0, t1=t1, clock=clock,
                              traced=traced[0] if traced else None), \
            setup_s, prof

    def outputs(self, tr, recs, seed: int) -> List[Dict]:
        return collect_outputs(tr, recs, self.taps, self.cell["check_rows"],
                               seed)

    def free(self) -> None:
        self.taps.close()
        self.taps = None
        self.eng = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", smoke: bool = False,
             bench: Optional[spec.Bench] = None, log=sys.stderr,
             limits: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """One run of ``--workload --seed --seconds --trace``; returns the
    result line as a dict (its ``checks`` last)."""
    bench = bench or spec.Bench()
    st = Setup(bench, workload, device=device, smoke=smoke, trace=trace,
               limits=limits)
    tr, recs, f, setup_s, prof = st.serve(seed, seconds, t_start,
                                          profile=trace and device == "cuda")
    cuda = st.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    taps = st.taps
    rows = st.outputs(tr, recs, seed)
    failed = sum(not r["ok"] for r in recs)
    run = Run(workload, st.conf, st.model, st.mix, f["t0"], f["t1"],
              seconds, recs, taps.dispatches, taps.steps, setup_s)
    breakdown = None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if prof is not None:
        host = [("prefill step", [(f["clock"].ns(a), f["clock"].ns(b))
                                  for _, a, b, *_ in taps.steps]),
                ("engine, outside the steps",
                 [(f["clock"].ns(a), f["clock"].ns(b))
                  for a, b, _ in taps.dispatches])]
        lo, hi = f["clock"].ns(f["t0"]), f["clock"].ns(f["traced"])
        ev = devtrace.clip(devtrace.device_events(prof), lo, hi)
        run.events, run.window_ns = ev, (lo, hi)
        run.clock_window = (f["t0"], f["traced"])
        device_info["busy_s"] = devtrace.busy_s(ev)
        device_info["window_s"] = (hi - lo) / 1e9
        breakdown = {"device_ops": devtrace.top_ops(ev),
                     "idle_gaps": devtrace.idle_gaps(ev, host, lo, hi)}
        del prof
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(workload, kind):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = len(recs)
    summary(run, log)
    del taps, run
    st.free()
    numbers = check(rows, st.arch, st.model, seed, st.device, st.tie)
    numbers["failed"] = float(failed)
    limits_all = dict(st.limits, failed=0.0)
    compared = {k: numbers.get(k, judge.BIG) for k in limits_all}
    ok = bool(st.limits) and judge.verdict(compared, limits_all)
    # every number compared beside its limit, then those only read
    checks = {k: {"value": compared[k], "limit": v}
              for k, v in limits_all.items()}
    checks.update({k: {"value": v, "limit": None}
                   for k, v in numbers.items() if k not in limits_all})
    out = {"correct": bool(ok), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def summary(run: Run, log) -> None:
    """Counts that go on earlier lines, not into the result: the queries,
    rows and dispatches of the window, its drain (from the close to the end
    of the last query) and its share of the window, and each query's time
    from submission to answer."""
    recs = run.queries
    took = [r["end"] - r["start"] for r in sorted(recs, key=lambda r: r["start"])
            if r["ok"]]
    rows = sum(r["rows"] for r in recs if r["ok"])
    span = run.t1 - run.t0
    drain = max(run.t1 - run.t0 - run.seconds, 0.0)
    extra = ""
    if took:
        extra = (f", a query p50 {timeline.nearest_rank(took, 0.5):.4f} s"
                 f" max {max(took):.4f} s first {took[0]:.4f} s")
    print(f"window {span:.3f} s ({run.seconds} s of submissions, drain "
          f"{drain:.3f} s = {100 * drain / span:.1f} %): "
          f"{len(recs)} queries, {sum(not r['ok'] for r in recs)} failed, "
          f"{rows} rows, {len(run.dispatches)} dispatches, "
          f"{len(run.steps)} prefill steps" + extra, file=log)
    for r in recs:
        if r["error"]:
            print(f"query failed: {r['error'][:300]}", file=log)
            break
