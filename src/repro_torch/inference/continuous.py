"""Continuous-batching decode backend (per-step admission, paged KV).

The PyTorch counterpart of ``repro.inference.continuous``:

  * **slots**: a fixed-width in-flight batch.  Every step, finished
    sequences retire (EOS or max_tokens), their KV blocks return to the
    pool, and queued requests are admitted into the freed slots;
  * **paged KV**: each sequence owns a block table over a shared pool
    (``paged_kv.PagedKVCache``); a step gathers the dense view, runs the
    model, and scatters only the newly valid keys/values back;
  * **chunked prefill**: prompts enter the cache ``prefill_chunk`` tokens
    at a time, batched across every prefilling slot and interleaved with
    decode steps;
  * **flash decode**: single-token steps route ``decode_attention``
    through ``kernels/decode_attention`` (``attention.use_decode_impl``):
    the CUDA kernel on the card, its plain version on the CPU;
  * **chunked-prefill attention**: on the card a prefill step's attention
    layers run K2's chunked entry (``attention.takes_chunked_kernel``):
    qk-norm, RoPE, the cache append and the attention in two launches a
    layer, counted in ``stats()["prefill_attn_kernel_layers"]``; latent
    attention (``MLA``) layers take the absorbed form in plain products
    over the gathered latent leaf;
  * **spans**: while tracing or a profiler is on, each ``serve`` call
    records a wave tree of step and phase spans (``obs/engine.py``).

Per-row results do not depend on batch composition.  They match the static
path of ``engine.py`` to within floating-point summation order, not
bitwise: chunked prefill and one-shot prefill sum in different orders.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import base as cfgs
from repro_torch.inference import tokenizer as tok
from repro_torch.inference.backend import (COMPLETE, SCORE, EngineFailure,
                                           Request, Result, credits_for)
from repro_torch.inference.paged_kv import PagedKVCache
from repro_torch.models import attention
from repro_torch.obs.engine import WaveRecorder
from repro_torch.train.optim import leaves, map_tree


def supports(cfg) -> bool:
    """Continuous batching serves pure global-attention decoders, GQA
    (``ATTN``) or latent (``MLA``): every block's cache must be a flat
    per-layer [B, Smax] tensor for the paged pool to tile."""
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        return False
    return all(b in (cfgs.ATTN, cfgs.MLA) for b in cfg.block_pattern)


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class _Seq:
    """One in-flight sequence (a slot's occupant)."""
    req: Request
    index: int                 # position in the submitted request list
    enc: List[int]             # encoded prompt
    slot: int
    blocks: List[int]
    state: str = "prefill"     # "prefill" -> "decode" (COMPLETE only)
    filled: int = 0            # prompt tokens already in the paged cache
    cur: int = -1              # last sampled token (next decode input)
    out: List[int] = dataclasses.field(default_factory=list)


class ContinuousBatcher:
    """Step loop + paged-KV state for one :class:`TorchInferenceEngine`.

    Owns no model or params: it drives the engine's model through its
    prefill and decode step functions.
    """

    def __init__(self, engine, *, block_size: int = 32,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 decode_impl: str = "auto"):
        self.engine = engine
        self.model = engine.model
        self.device = engine.device
        self.slots = engine.max_batch
        self.block_size = int(block_size)
        self.prefill_chunk = int(prefill_chunk)
        self.decode_impl = decode_impl
        if num_blocks is None:
            # every slot can hold a full-length prompt plus a generous
            # generation budget; +1 for the scratch block
            per_seq = -(-(engine.max_seq + 4 * self.prefill_chunk)
                        // self.block_size)
            num_blocks = self.slots * per_seq + 1
        self.kv = PagedKVCache(self.model, block_size=self.block_size,
                               num_blocks=num_blocks, device=self.device)
        width = self.kv.max_seq_blocks
        self.tables_np = np.zeros((self.slots, width), np.int32)
        self.lens_np = np.zeros((self.slots,), np.int32)
        # device mirror of (block tables, lengths, decode-active mask),
        # valid between slot mutations; see _device_state
        self._dev: Optional[Dict[str, Any]] = None
        # telemetry
        self.waves = 0             # serve() calls
        self.admitted = 0          # sequences admitted into slots
        self.retired = 0
        self.retired_eos = 0       # retired on EOS before max_tokens
        self.prefill_steps = 0
        self.decode_steps = 0
        self.prefill_tokens = 0    # prompt tokens written via chunked prefill
        # layers of prefill steps that ran K2's chunked entry, as each
        # step's forward counts them (``_prefill_fn``)
        self.prefill_attn_kernel_layers = 0
        self._chunked_layers = 0
        self.decode_tokens = 0     # decode-step slot participations
        self.peak_blocks = 0
        # roofline: the arguments of the largest step of each kind
        self._step_args: Dict[str, Tuple[int, Tuple[Any, ...]]] = {}
        self._rec = WaveRecorder(self.device)

    # ------------------------------------------------------------------
    # serve loop
    # ------------------------------------------------------------------

    def serve(self, requests: Sequence[Request],
              t0: Optional[float] = None) -> List[Result]:
        """Serve SCORE/COMPLETE requests to completion; returns results in
        submission order with per-request completion-time latency."""
        t0 = time.perf_counter() if t0 is None else t0
        self.waves += 1
        with self._rec.wave(self.engine.obs, self.engine.engine_id,
                            self.waves, requests):
            pending: Deque[_Seq] = deque()
            for i, r in enumerate(requests):
                enc = tok.encode(r.prompt, max_len=self.engine.max_seq)
                pending.append(_Seq(req=r, index=i, enc=enc, slot=-1,
                                    blocks=[]))
            active: List[Optional[_Seq]] = [None] * self.slots
            results: List[Optional[Result]] = [None] * len(requests)
            while pending or any(s is not None for s in active):
                self._admit(pending, active)
                if any(s is not None and s.state == "prefill"
                       for s in active):
                    self._prefill_step(active, results, t0)
                if any(s is not None and s.state == "decode"
                       for s in active):
                    self._decode_step(active, results, t0)
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------

    def _blocks_needed(self, seq: _Seq) -> int:
        horizon = len(seq.enc)
        if seq.req.kind == COMPLETE:
            horizon += max(int(seq.req.max_tokens), 1)
        return self.kv.blocks_for(horizon)

    def _admit(self, pending: Deque[_Seq], active: List[Optional[_Seq]]
               ) -> int:
        """FIFO admission into free slots while KV blocks last.  Head-of-
        line order is kept deliberately: skipping ahead would make results
        depend on pool pressure."""
        n = 0
        free_slots = [i for i, s in enumerate(active) if s is None]
        while pending and free_slots:
            seq = pending[0]
            need = self._blocks_needed(seq)
            if need > self.kv.max_seq_blocks:
                pending.popleft()
                raise EngineFailure(
                    f"{self.engine.engine_id}: request {seq.req.request_id} "
                    f"needs {need} KV blocks, pool holds "
                    f"{self.kv.max_seq_blocks} (raise kv_blocks)")
            if not self.kv.can_alloc(need):
                break
            pending.popleft()
            seq.slot = free_slots.pop(0)
            seq.blocks = self.kv.alloc(need)
            self.tables_np[seq.slot, :] = 0
            self.tables_np[seq.slot, :need] = seq.blocks
            self.lens_np[seq.slot] = 0
            active[seq.slot] = seq
            n += 1
        if n:
            self._dev = None
        self.admitted += n
        used = self.kv.num_blocks - 1 - self.kv.free_count
        self.peak_blocks = max(self.peak_blocks, used)
        return n

    def _device_state(self, active: List[Optional[_Seq]], nb: int
                      ) -> Dict[str, Any]:
        """Device mirror of the per-slot step state, rebuilt from the host
        arrays only when a slot mutated or the bucketed table width
        changed; in steady-state decode the only per-step host-to-device
        copy is the sampled-token vector.  ``lens`` advances on the device
        (each step returns the new lengths)."""
        if self._dev is None or self._dev["nb"] != nb:
            act = np.asarray(
                [1 if (s is not None and s.state == "decode") else 0
                 for s in active], np.int32)
            dev = self.device
            self._dev = {
                "nb": nb,
                "tables": torch.as_tensor(self.tables_np[:, :nb].copy(),
                                          device=dev),
                "lens": torch.as_tensor(self.lens_np.copy(), device=dev),
                "act": torch.as_tensor(act, device=dev),
            }
        return self._dev

    def _gather_width(self, active: List[Optional[_Seq]], horizon: int
                      ) -> int:
        """Block-table width for this step: max blocks any live row needs
        to cover ``len + horizon`` tokens, bucketed to a power of two."""
        nb = 1
        for s in active:
            if s is not None:
                h = horizon if s.state == "prefill" else 1
                nb = max(nb, self.kv.blocks_for(int(self.lens_np[s.slot]) + h))
        return min(_pow2(nb), self.kv.max_seq_blocks)

    # ------------------------------------------------------------------
    # batched chunked prefill
    # ------------------------------------------------------------------

    def _prefill_step(self, active, results, t0) -> None:
        rec = self._rec
        with rec.step("prefill") as span:
            with rec.phase("step.upload"):
                C = self.prefill_chunk
                B = self.slots
                nb = self._gather_width(active, C)
                toks = np.zeros((B, C), np.int32)
                counts = np.zeros((B,), np.int32)
                pre = [s for s in active
                       if s is not None and s.state == "prefill"]
                for s in pre:
                    v = min(C, len(s.enc) - s.filled)
                    toks[s.slot, :v] = s.enc[s.filled:s.filled + v]
                    counts[s.slot] = v
                dev = self._device_state(active, nb)
                args = (dev["tables"], dev["lens"],
                        torch.as_tensor(counts, device=self.device),
                        torch.as_tensor(toks, device=self.device))
                self._record_step("prefill", B * C, args)
            if span is not None:
                at = []
                for s in pre:
                    v = int(counts[s.slot])
                    at.append([s.filled, v, int(s.filled + v == len(s.enc))])
                span.set(rows=sum(s is not None for s in active),
                         tokens=int(counts.sum()), nb=nb, rows_at=at)
            logits, new_lens = self._prefill_fn(*args)
            self.prefill_attn_kernel_layers += self._chunked_layers
            self.prefill_steps += 1
            self.prefill_tokens += int(counts.sum())
            for s in pre:
                v = int(counts[s.slot])
                s.filled += v
                self.lens_np[s.slot] += v
            dev["lens"] = new_lens
            lf = None
            for s in pre:
                if s.filled >= len(s.enc):
                    if lf is None:
                        with rec.phase("step.readback"):
                            lf = logits.float().cpu().numpy()
                    self._finish_prefill(s, lf[s.slot], active, results, t0)

    def _prefill_fn(self, tables, lens, counts, toks):
        params = self.engine.params
        phase = self._rec.phase
        with phase("step.gather"):
            cache = self.kv.gather(self.kv.pool, tables, lens)
        with phase("step.forward"):
            C = toks.shape[1]
            pos = lens[:, None] + torch.arange(C, dtype=torch.int32,
                                               device=toks.device)[None]
            # valid: the chunk's real tokens (a recorded MoE layer counts
            # the experts of those alone)
            valid = (torch.arange(C, device=toks.device)[None]
                     < counts[:, None])
            out = self.model.apply(params, {"tokens": toks, "positions": pos,
                                            "valid": valid},
                                   mode="decode", cache=cache)
            self._chunked_layers = out.get("chunked_layers", 0)
        with phase("step.logits"):
            last = (counts - 1).clamp(0, C - 1).long()
            h = out["hidden"][torch.arange(toks.shape[0], device=toks.device),
                              last]
            logits = self.model.logits_of(params, h)
        with phase("step.scatter"):
            self.kv.scatter(self.kv.pool, out["cache"], tables, lens, counts,
                            C)
        return logits, lens + counts

    def _finish_prefill(self, s: _Seq, logits_row: np.ndarray, active,
                        results, t0) -> None:
        r = s.req
        if r.kind == SCORE:
            # identical arithmetic to the static _score_batch
            py = logits_row[tok.YES_ID]
            pn = logits_row[tok.NO_ID]
            score = 1.0 / (1.0 + np.exp(-(py - pn)))
            self._retire(s, active, results, t0, score=float(score))
            return
        s.cur = int(np.argmax(logits_row))
        s.state = "decode"
        self._dev = None        # slot joins the decode-active mask
        self._consume(s, active, results, t0)

    # ------------------------------------------------------------------
    # decode step
    # ------------------------------------------------------------------

    def _decode_step(self, active, results, t0) -> None:
        rec = self._rec
        with rec.step("decode") as span:
            with rec.phase("step.upload"):
                B = self.slots
                nb = self._gather_width(active, 1)
                cur = np.zeros((B, 1), np.int32)
                dec = [s for s in active
                       if s is not None and s.state == "decode"]
                for s in dec:
                    cur[s.slot, 0] = s.cur
                dev = self._device_state(active, nb)
                args = (dev["tables"], dev["lens"], dev["act"],
                        torch.as_tensor(cur, device=self.device))
                self._record_step("decode", B, args)
            if span is not None:
                span.set(rows=sum(s is not None for s in active),
                         tokens=len(dec), nb=nb)
            nxt_dev, new_lens = self._decode_fn(*args)
            self.decode_steps += 1
            self.decode_tokens += len(dec)
            with rec.phase("step.readback"):
                nxt = nxt_dev.cpu().numpy().astype(np.int32)
            for s in dec:
                self.lens_np[s.slot] += 1
            dev["lens"] = new_lens
            for s in dec:
                s.cur = int(nxt[s.slot])
                self._consume(s, active, results, t0)

    def _decode_fn(self, tables, lens, act, cur):
        params = self.engine.params
        phase = self._rec.phase
        with phase("step.gather"):
            cache = self.kv.gather(self.kv.pool, tables, lens)
        with phase("step.forward"):
            with attention.use_decode_impl(self.decode_impl):
                out = self.model.apply(params, {"tokens": cur,
                                                "valid": act[:, None] > 0},
                                       mode="decode", cache=cache)
        with phase("step.logits"):
            logits = self.model.logits_of(params, out["hidden"][:, 0])
            nxt = torch.argmax(logits, -1)
        with phase("step.scatter"):
            self.kv.scatter(self.kv.pool, out["cache"], tables, lens, act, 1)
        return nxt, lens + act

    def _consume(self, s: _Seq, active, results, t0) -> None:
        """Append the sampled token and retire on EOS / max_tokens:
        exactly the static loop's append-then-check chain."""
        s.out.append(s.cur)
        if s.cur == tok.EOS_ID or len(s.out) >= s.req.max_tokens:
            if s.cur == tok.EOS_ID and len(s.out) < s.req.max_tokens:
                self.retired_eos += 1
            self._retire(s, active, results, t0)

    # ------------------------------------------------------------------

    def _retire(self, s: _Seq, active, results, t0,
                score: Optional[float] = None) -> None:
        r = s.req
        eng = self.engine
        ti = len(s.enc)
        if r.kind == SCORE:
            res = Result(r.request_id, eng.arch, SCORE, score=score,
                         tokens_in=ti, credits=credits_for(eng.arch, ti),
                         engine_id=eng.engine_id)
        else:
            res = Result(r.request_id, eng.arch, COMPLETE,
                         text=tok.decode(s.out), tokens_in=ti,
                         tokens_out=len(s.out),
                         credits=credits_for(eng.arch, ti + len(s.out)),
                         engine_id=eng.engine_id)
        res.latency_s = time.perf_counter() - t0
        results[s.index] = res
        self.kv.free_blocks(s.blocks)
        active[s.slot] = None
        self.lens_np[s.slot] = 0
        self.tables_np[s.slot, :] = 0
        self._dev = None
        self.retired += 1

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def _record_step(self, kind: str, tokens_per_step: int, args) -> None:
        """Keep copies of the arguments of the largest step of each kind
        (the latest of equals), as the JAX package records its steps'
        abstract arguments."""
        if (kind not in self._step_args
                or tokens_per_step >= self._step_args[kind][0]):
            self._step_args[kind] = (tokens_per_step,
                                     tuple(a.clone() for a in args))

    def roofline_report(self) -> Dict[str, Any]:
        """Roofline-derived utilization per step kind (prefill vs decode):
        the largest step of each kind runs again under ``launch/op_cost``'s
        counter (``launch/roofline.analyze_step``), on a copy of the KV
        pool, so the served state is untouched.  Empty before any step."""
        from repro_torch.launch import roofline
        n_params = sum(t.numel() for t in leaves(self.engine.params))
        fns = {"prefill": self._prefill_fn, "decode": self._decode_fn}
        out: Dict[str, Any] = {}
        for kind, (tps, args) in self._step_args.items():
            pool = self.kv.pool
            self.kv.pool = map_tree(torch.clone, pool)
            try:
                r = roofline.analyze_step(
                    fns[kind], args, arch=self.engine.arch,
                    shape=f"{kind}-step B={self.slots}",
                    model_flops=2.0 * n_params * tps)
            finally:
                self.kv.pool = pool
            out[kind] = {"tokens_per_step": tps, **r.to_dict()}
        return out

    def stats(self) -> Dict[str, Any]:
        occ = (self.decode_tokens / (self.decode_steps * self.slots)
               if self.decode_steps else 0.0)
        return {
            "waves": self.waves, "admitted": self.admitted,
            "retired": self.retired, "retired_eos": self.retired_eos,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "prefill_tokens": self.prefill_tokens,
            "prefill_attn_kernel_layers": self.prefill_attn_kernel_layers,
            "decode_tokens": self.decode_tokens,
            "decode_slot_occupancy": occ,
            "kv_blocks": self.kv.num_blocks,
            "kv_block_size": self.block_size,
            "kv_peak_blocks": self.peak_blocks,
        }

