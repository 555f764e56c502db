"""Spans inside the continuous batcher: one tree per wave.

A wave is one ``ContinuousBatcher.serve`` call.  Its tree is an
``engine.wave`` root span over the wave's ``engine.step`` spans (one a
prefill or decode step), each over the step's phases in order:
``step.upload``, ``step.gather``, ``step.forward``, ``step.logits``,
``step.scatter`` and, on the steps that copy logits or tokens to the host,
``step.readback``.  Every wave gets its own :class:`Tracer` on
``time.perf_counter``, the clock of the query spans, and the finished tree
goes into one process-wide bounded :class:`TraceRing` keyed
``"<engine_id>/<wave n>"``, read through :func:`engine_ring`.

**The gate.**  A wave records only while the serving process's
``Observability`` is enabled (``ServingEngine`` hands its ``obs`` to the
engines it serves) or a ``torch.profiler`` session is running in the
process (``torch.autograd.profiler._is_profiler_enabled``: the profiler's
own state, ``torch.autograd._profiler_enabled()``, is per thread, and the
serving workers are not the thread that started the profiler).  The gate
is read when a wave opens and again at each of its steps; once it reads
off inside a wave, the rest of the wave's steps go unrecorded and the wave
says from when (``unrecorded_from``).  With the gate off no span, CUDA
event or ``record_function`` range is made: a step costs one attribute
check.  Phase spans outside a recorded step (``roofline_report``'s reruns
of the step functions) record nothing.

**Device time.**  On CUDA each phase records a pooled
``torch.cuda.Event(enable_timing=True)`` at its open and at its close.
When the wave closes, its last readback has drained the stream, and each
phase gets the stream time between its two events as ``device_ms``; no
synchronize is added.  On the CPU phases carry no ``device_ms``.

**Profiler ranges.**  While a profiler runs, each span also opens
``torch.autograd.profiler.record_function(<its name>)``, so the profiler's
trace carries the same names on its own clock (torch records such ranges
only on the thread that started the profiler).

**Layer spans and notes.**  Inside a recorded step the layers may open
spans of their own (:func:`layer`; an ``MLA`` block's ``layer.attn``
and ``layer.ffn``, in ``models/blocks.py``), nested in ``step.forward``
and timed as the phases are, and attach device tensors to the innermost
open span (:func:`note`; the MoE layer's ``experts_hit`` and
``max_expert_tokens``).  The notes are copied to the host once, when the
wave closes, and stored as numbers among the span's attributes.  The
recorder of the step open on the calling thread is a thread-local, so
outside a recorded step a layer pays one thread-local read.

Wave attributes: ``engine_id``, ``wave`` (the batcher's wave number),
``requests``, ``request_ids``, ``kinds`` (requests by kind),
``prev_wave_end`` (when the engine's previous wave ended, ``None`` for its
first: no step ran in between) and, where the gate closed inside the wave,
``unrecorded_from``.  Step attributes: ``kind``, ``rows`` (occupied
slots), ``tokens`` (written this step), ``nb`` (the gather width in
blocks) and, on prefill steps, ``rows_at``: ``[start, count, last]`` of
each prefilling row.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, List, Optional, Sequence

import torch

from .trace import TraceRing, Tracer

_RING = TraceRing(64)


class _Local(threading.local):
    rec = None              # the recorder whose recorded step is open


_LOCAL = _Local()


def engine_ring() -> TraceRing:
    """The process-wide ring of the batchers' wave trees (span dicts),
    keyed ``"<engine_id>/<wave n>"``; the oldest waves are evicted."""
    return _RING


def _gate(obs):
    """(record, a profiler runs): the gate is an enabled ``Observability``
    or a profiler running anywhere in the process."""
    prof = torch.autograd.profiler._is_profiler_enabled
    return prof or (obs is not None and obs.enabled), prof


class _Off:
    """The context of a span that is not recorded: yields None."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """One recorded span: the tracer's span, the profiler's range while a
    profiler runs, and on CUDA a pair of pooled events (phases only)."""
    __slots__ = ("rec", "name", "timed", "cm", "rf", "span", "ev")

    def __init__(self, rec: "WaveRecorder", name: str, timed: bool):
        self.rec, self.name, self.timed = rec, name, timed

    def __enter__(self):
        rec = self.rec
        self.cm = rec._tracer.span(self.name, kind=self.name)
        self.rf = None
        if rec._prof:
            # the range opens just before the span reads its clock, and
            # closes just before the span does, so the two stay together
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.span = self.cm.__enter__()
        self.ev = None
        if self.timed and rec.cuda:
            self.ev = rec._event()
            self.ev.record()
        return self.span

    def __exit__(self, *exc):
        rec = self.rec
        if self.ev is not None:
            end = rec._event()
            end.record()
            rec._timed.append((self.span, self.ev, end))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return self.cm.__exit__(*exc)


class WaveRecorder:
    """The span recorder of one continuous batcher."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.last_end: Optional[float] = None   # the previous wave's end
        self._tracer: Optional[Tracer] = None   # the open wave's tracer
        self._wave = None                       # ... and its root span
        self._obs = None
        self._prof = False      # a profiler ran when the step (wave) opened
        self._stepping = False  # a recorded step is open
        self._cut = False       # the gate closed inside the open wave
        self._timed: List[Any] = []   # (span, open event, close event)
        self._noted: List[Any] = []   # (span, attribute names, tensor)
        self._pool: List[Any] = []

    def _event(self):
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    # -- the wave ----------------------------------------------------------
    @contextmanager
    def wave(self, obs, engine_id: str, n: int, requests: Sequence):
        """The context of wave ``n``: recorded if the gate holds when it
        opens, then put into the engine ring when it closes."""
        self._open(obs, engine_id, n, requests)
        try:
            yield
        finally:
            self._close(f"{engine_id}/{n}")

    def _open(self, obs, engine_id, n, requests) -> None:
        on, self._prof = _gate(obs)
        if not on:
            return
        self._obs, self._cut = obs, False
        self._tracer = Tracer(clock=time.perf_counter)
        kinds: dict = {}
        for r in requests:
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
        self._wave = _On(self, "engine.wave", False)
        root = self._wave.__enter__()
        root.set(engine_id=engine_id, wave=n, requests=len(requests),
                 request_ids=[r.request_id for r in requests], kinds=kinds,
                 prev_wave_end=self.last_end)

    def _close(self, key: str) -> None:
        """Close the open wave (if any), write the phases' device times and
        put its tree into the engine ring under ``key``."""
        end = time.perf_counter()
        if self._tracer is not None:
            tracer, wave = self._tracer, self._wave
            self._tracer = self._wave = None
            wave.__exit__(None, None, None)
            for span, e0, e1 in self._timed:
                # every event before the wave's last readback has passed;
                # the readback's own closing event may not have yet
                if e1.query():
                    span.attrs["device_ms"] = e0.elapsed_time(e1)
                self._pool += (e0, e1)
            self._timed = []
            if self._noted:
                # one copy to the host; the notes were made in forwards
                # that the last readback has drained
                got = torch.cat([t for *_, t in self._noted]).tolist()
                i = 0
                for span, names, t in self._noted:
                    span.attrs.update(zip(names, got[i:i + len(names)]))
                    i += len(names)
                self._noted = []
            _RING.put(key, tracer.to_dict())
        self.last_end = end

    # -- steps and phases --------------------------------------------------
    def step(self, kind: str):
        """The context of one step: yields its span, or None when the step
        is not recorded.  Reads the gate once."""
        if self._tracer is None or self._cut:
            return _OFF
        on, self._prof = _gate(self._obs)
        if not on:
            self._cut = True
            self._wave.span.set(unrecorded_from=time.perf_counter())
            return _OFF
        return _Step(self, kind)

    def phase(self, name: str):
        """The context of one phase of the open step; records nothing
        outside a recorded step."""
        return _On(self, name, True) if self._stepping else _OFF


class _Step(_On):
    __slots__ = ("kind",)

    def __init__(self, rec: WaveRecorder, kind: str):
        super().__init__(rec, "engine.step", False)
        self.kind = kind

    def __enter__(self):
        span = super().__enter__()
        span.set(kind=self.kind)
        self.rec._stepping = True
        _LOCAL.rec = self.rec
        return span

    def __exit__(self, *exc):
        self.rec._stepping = False
        _LOCAL.rec = None
        return super().__exit__(*exc)


def recording() -> Optional[WaveRecorder]:
    """The recorder of the recorded step open on this thread, or None."""
    return _LOCAL.rec


def layer(name: str):
    """The context of a layer's span inside the recorded step open on this
    thread (timed on CUDA as a phase is); records nothing elsewhere."""
    rec = _LOCAL.rec
    return _OFF if rec is None else _On(rec, name, True)


def note(**values) -> None:
    """Attach 0-d device tensors to the innermost open span of the
    recorded step open on this thread, as attributes read when the wave
    closes; nothing elsewhere."""
    rec = _LOCAL.rec
    if rec is not None:
        rec._noted.append((rec._tracer._stack[-1], tuple(values),
                           torch.stack(list(values.values()))))
