"""PyTorch inference engine: one hosted model, continuous-batching decode.

The counterpart of ``repro.inference.engine.JaxInferenceEngine`` behind the
same ``submit_batch`` backend protocol:

  * **continuous batching** (pure-attention decoders): fixed [max_batch]
    slots over a paged KV cache; finished sequences retire at EOS and
    queued work is admitted at every decode step, with long prompts
    chunk-prefilled between steps (``inference/continuous.py``).  SCORE
    and COMPLETE ride this path; CLASSIFY and EMBED (single forward passes)
    use the static path below;
  * static-shape batch fallback: one prefill + decode loop per batch,
    finished sequences retiring early from the loop;
  * bucketed prefill lengths (powers of two) and decode batch sizes;
  * four request kinds: COMPLETE (greedy decode), SCORE (yes/no confidence
    from next-token logits), CLASSIFY (label-likelihood over a candidate
    set), EMBED (masked mean-pooled hidden states projected to the
    requested dimensionality);
  * per-request credit metering and latency accounting;
  * fault injection (EngineFailure) for the scheduler's retry logic.

The engine runs on a CUDA device unless the caller passes ``device="cpu"``;
it never falls back to the CPU on its own.
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.inference import tokenizer as tok
from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED, SCORE,
                                           EngineFailure, Request, Result,
                                           credits_for)
from repro_torch.models import model_zoo


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _hash_embed(key: str, shape, scale=0.1) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _stamp_latency(results: List[Result], t0: float) -> List[Result]:
    """Chunk-level latency for single-forward-pass kinds."""
    lat = time.perf_counter() - t0
    for r in results:
        r.latency_s = lat
    return results


class TorchInferenceEngine:
    """Hosts one model and serves batched requests.

    ``arch`` is a model id (its full or, with ``smoke``, its smoke config)
    or a `ModelConfig` taken as it is, e.g. a model with its depth cut; the
    engine serves and meters it under the config's name."""

    def __init__(self, arch: Union[str, ModelConfig], *, engine_id: str = "",
                 smoke: bool = True,
                 max_batch: int = 8, max_seq: int = 384, seed: int = 0,
                 failure_rate: float = 0.0, straggle_s: float = 0.0,
                 backend: str = "auto", block_size: int = 32,
                 kv_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 decode_impl: str = "auto", device: str = "cuda"):
        from repro_torch.inference import continuous as cb
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchInferenceEngine: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        self.model = model_zoo.build(arch, smoke=smoke)
        self.cfg = self.model.cfg
        self.arch = arch = arch if isinstance(arch, str) else self.cfg.name
        self.engine_id = engine_id or f"{arch}#0"
        if self.cfg.vocab_size < tok.VOCAB_SIZE:
            raise ValueError(f"{arch}: vocab smaller than the tokenizer's")
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.failure_rate = failure_rate
        self.straggle_s = straggle_s
        self._rng = np.random.default_rng(seed + 17)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = self.model.init_params(gen)
        if backend == "auto":
            backend = "continuous" if cb.supports(self.cfg) else "static"
        elif backend == "continuous" and not cb.supports(self.cfg):
            raise ValueError(f"{arch}: architecture does not support the "
                             "continuous paged-KV backend")
        elif backend not in ("continuous", "static"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._batcher = None
        if backend == "continuous":
            self._batcher = cb.ContinuousBatcher(
                self, block_size=block_size, num_blocks=kv_blocks,
                prefill_chunk=prefill_chunk, decode_impl=decode_impl)
        # telemetry
        self.total_requests = 0
        self.total_tokens = 0
        self.total_credits = 0.0

    # ------------------------------------------------------------------
    # batching helpers
    # ------------------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _encode_batch(self, prompts: Sequence[str], cap: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
        enc = [tok.encode(p, max_len=cap) for p in prompts]
        lens = np.asarray([len(e) for e in enc], np.int32)
        L = min(_bucket(int(lens.max())), cap)
        toks = np.full((len(enc), L), tok.PAD_ID, np.int32)
        for i, e in enumerate(enc):
            toks[i, :len(e)] = e[:L]
        return toks, np.minimum(lens, L), L

    def _prefill(self, requests: Sequence[Request], cap: Optional[int] = None,
                 extra_capacity: int = 0):
        cap = cap or self.max_seq
        toks, lens, L = self._encode_batch([r.prompt for r in requests], cap)
        cache = self.model.init_cache(len(requests), L + extra_capacity,
                                      device=self.device)
        batch = {"tokens": self._tensor(toks), "lengths": self._tensor(lens)}
        out = self.model.apply(self.params, batch, mode="prefill",
                               cache=cache)
        logits = self.model.logits_of(self.params, out["last_hidden"])
        return logits, out["cache"], lens, L

    # ------------------------------------------------------------------
    # request kinds
    # ------------------------------------------------------------------

    def _score_batch(self, requests: Sequence[Request],
                     t0: Optional[float] = None) -> List[Result]:
        t0 = time.perf_counter() if t0 is None else t0
        logits, _, lens, _ = self._prefill(requests)
        lf = logits.float().cpu().numpy()
        py = lf[:, tok.YES_ID]
        pn = lf[:, tok.NO_ID]
        score = 1.0 / (1.0 + np.exp(-(py - pn)))   # P(yes | {yes,no})
        lat = time.perf_counter() - t0
        return [
            Result(r.request_id, self.arch, SCORE, score=float(score[i]),
                   tokens_in=int(lens[i]),
                   credits=credits_for(self.arch, int(lens[i])),
                   latency_s=lat, engine_id=self.engine_id)
            for i, r in enumerate(requests)]

    def _unlabeled(self, r: Request) -> Result:
        # no candidate labels: still a served (and metered) request
        ti = len(tok.encode(r.prompt, max_len=self.max_seq))
        return Result(r.request_id, self.arch, CLASSIFY, label=None,
                      labels=(), tokens_in=ti,
                      credits=credits_for(self.arch, ti),
                      engine_id=self.engine_id)

    def _classify_batch(self, requests: Sequence[Request],
                        t0: Optional[float] = None) -> List[Result]:
        """Label-likelihood classification: logprob of each candidate label
        as a continuation of the prompt, softmax over candidates."""
        t0 = time.perf_counter() if t0 is None else t0
        flat_prompts, flat_labels, owners = [], [], []
        for i, r in enumerate(requests):
            for lb in (r.labels or ()):
                flat_prompts.append(r.prompt + "\nanswer: ")
                flat_labels.append(lb)
                owners.append(i)
        if not flat_prompts:
            return _stamp_latency([self._unlabeled(r) for r in requests], t0)
        lps, tokens_used = self._sequence_logprob(flat_prompts, flat_labels)
        per_req: Dict[int, List[Tuple[str, float]]] = {}
        for o, lb, lp in zip(owners, flat_labels, lps):
            per_req.setdefault(o, []).append((lb, lp))
        tokens_per_req: Dict[int, int] = {}
        for o, t in zip(owners, tokens_used):
            tokens_per_req[o] = tokens_per_req.get(o, 0) + t
        results = []
        for i, r in enumerate(requests):
            pairs = per_req.get(i, [])
            if not pairs:
                results.append(self._unlabeled(r))
                continue
            lbls = [p[0] for p in pairs]
            lp = np.asarray([p[1] for p in pairs])
            probs = np.exp(lp - lp.max())
            probs = probs / probs.sum()
            order = np.argsort(-probs)
            top = lbls[int(order[0])]
            if r.multi_label:
                thr = 1.5 / max(len(lbls), 2)
                chosen = tuple(lbls[j] for j in order
                               if probs[j] >= thr) or (top,)
            else:
                chosen = (top,)
            ti = tokens_per_req.get(i, 0)
            results.append(Result(
                r.request_id, self.arch, CLASSIFY, label=top, labels=chosen,
                tokens_in=ti, credits=credits_for(self.arch, ti),
                engine_id=self.engine_id))
        return _stamp_latency(results, t0)

    def _sequence_logprob(self, prompts: Sequence[str],
                          continuations: Sequence[str]):
        """Mean per-token logprob of each continuation given its prompt."""
        seqs, masks = [], []
        for p, c in zip(prompts, continuations):
            pe = tok.encode(p, max_len=self.max_seq // 2)
            ce = tok.encode(c, bos=False)
            seqs.append(pe + ce)
            masks.append([0] * len(pe) + [1] * len(ce))
        L = min(_bucket(max(len(s) for s in seqs)), self.max_seq)
        B = len(seqs)
        toks = np.full((B, L), tok.PAD_ID, np.int32)
        msk = np.zeros((B, L), np.float32)
        for i, (s, m) in enumerate(zip(seqs, masks)):
            s, m = s[:L], m[:L]
            toks[i, :len(s)] = s
            msk[i, :len(m)] = m
        tokens = self._tensor(toks)
        out = self.model.apply(self.params, {"tokens": tokens}, mode="train")
        logits = self.model.logits_of(self.params, out["hidden"])
        logp = torch.log_softmax(logits.float(), dim=-1)
        # hidden[t] predicts token[t+1]
        tgt = tokens[:, 1:].long()
        lp = torch.gather(logp[:, :-1], -1, tgt[..., None])[..., 0]
        m = self._tensor(msk)[:, 1:]
        lps = (lp * m).sum(1) / m.sum(1).clamp_min(1.0)
        return (lps.cpu().numpy().tolist(),
                [int(m.sum() + (1 - m).sum()) for m in msk])

    def _embed_batch(self, requests: Sequence[Request],
                     t0: Optional[float] = None) -> List[Result]:
        """Masked mean-pool of the final hidden states, projected to the
        requested dimensionality by a fixed seeded matrix and unit-
        normalized."""
        t0 = time.perf_counter() if t0 is None else t0
        toks, lens, L = self._encode_batch([r.prompt for r in requests],
                                           self.max_seq)
        out = self.model.apply(self.params, {"tokens": self._tensor(toks)},
                               mode="train")
        h = out["hidden"].float()                              # [B, L, D]
        mask = (torch.arange(L, device=self.device)[None, :]
                < self._tensor(lens)[:, None]).float()
        pooled = ((h * mask[..., None]).sum(1)
                  / mask.sum(1, keepdim=True).clamp_min(1.0))
        pooled = pooled.cpu().numpy()
        results = []
        for i, r in enumerate(requests):
            dim = int(r.metadata.get("embed_dim", 64))
            proj = _hash_embed(f"{self.arch}|embed-proj|{dim}",
                               (pooled.shape[1], dim), scale=1.0)
            v = pooled[i] @ proj
            v = v / max(float(np.linalg.norm(v)), 1e-12)
            results.append(Result(
                r.request_id, self.arch, EMBED,
                embedding=tuple(float(x) for x in v),
                tokens_in=int(lens[i]),
                credits=credits_for(self.arch, int(lens[i]), EMBED),
                engine_id=self.engine_id))
        return _stamp_latency(results, t0)

    def _complete_batch(self, requests: Sequence[Request],
                        t0: Optional[float] = None) -> List[Result]:
        """Greedy decode over batch slots; finished sequences retire early
        (the static fallback path)."""
        t0 = time.perf_counter() if t0 is None else t0
        B0 = len(requests)
        max_new = max(r.max_tokens for r in requests)
        # bucket the decode batch to powers of two: per-row results are
        # batch-independent, so sentinel rows change nothing
        Bp = _bucket(B0, lo=1)
        padded: List[Request] = list(requests) + [
            Request("", self.arch, COMPLETE, max_tokens=1)
            for _ in range(Bp - B0)]
        logits, cache, lens, _ = self._prefill(
            padded, extra_capacity=_bucket(max(max_new, 1), lo=16))
        cur = torch.argmax(logits, -1).cpu().numpy().astype(np.int32)[:, None]
        done = np.zeros(Bp, bool)
        outs: List[List[int]] = [[] for _ in range(Bp)]
        finish = [t0] * Bp
        for _ in range(max_new):
            for i in range(Bp):
                if not done[i]:
                    outs[i].append(int(cur[i, 0]))
                    if (cur[i, 0] == tok.EOS_ID
                            or len(outs[i]) >= padded[i].max_tokens):
                        done[i] = True
                        finish[i] = time.perf_counter()
            if done.all():
                break
            out = self.model.apply(self.params, {"tokens": self._tensor(cur)},
                                   mode="decode", cache=cache)
            cache = out["cache"]
            lg = self.model.logits_of(self.params, out["hidden"][:, 0])
            cur = torch.argmax(lg, -1).cpu().numpy().astype(np.int32)[:, None]
        end = time.perf_counter()
        results = []
        for i, r in enumerate(requests):
            ntok = int(lens[i]) + len(outs[i])
            results.append(Result(
                r.request_id, self.arch, COMPLETE, text=tok.decode(outs[i]),
                tokens_in=int(lens[i]), tokens_out=len(outs[i]),
                credits=credits_for(self.arch, ntok),
                latency_s=(finish[i] if done[i] else end) - t0,
                engine_id=self.engine_id))
        return results

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit_batch(self, requests: Sequence[Request]) -> List[Result]:
        if self.failure_rate and self._rng.random() < self.failure_rate:
            raise EngineFailure(f"{self.engine_id}: injected fault")
        if self.straggle_s:
            time.sleep(self.straggle_s)
        t0 = time.perf_counter()
        out: List[Result] = []
        cont: List[Request] = []
        by_kind: Dict[str, List[Request]] = {}
        for r in requests:
            if self._batcher is not None and r.kind in (SCORE, COMPLETE):
                cont.append(r)
            else:
                by_kind.setdefault(r.kind, []).append(r)
        with torch.no_grad():
            if cont:
                out.extend(self._batcher.serve(cont, t0))
            for kind, reqs in by_kind.items():
                for i in range(0, len(reqs), self.max_batch):
                    chunk = reqs[i:i + self.max_batch]
                    if kind == SCORE:
                        out.extend(self._score_batch(chunk, t0))
                    elif kind == CLASSIFY:
                        out.extend(self._classify_batch(chunk, t0))
                    elif kind == EMBED:
                        out.extend(self._embed_batch(chunk, t0))
                    else:
                        out.extend(self._complete_batch(chunk, t0))
        for r in out:
            self.total_credits += r.credits
            self.total_tokens += r.tokens_in + r.tokens_out
        self.total_requests += len(requests)
        return self._restore_order(requests, out)

    def _restore_order(self, requests: Sequence[Request],
                       out: List[Result]) -> List[Result]:
        """Return results in submission order.  Duplicated request ids map
        to submission positions in production order (stable); a result
        whose id was never submitted is an engine invariant violation."""
        slots: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            slots.setdefault(r.request_id, []).append(i)
        taken: Dict[int, int] = {}
        keyed: List[Tuple[int, Result]] = []
        for res in out:
            positions = slots.get(res.request_id)
            k = taken.get(res.request_id, 0)
            if positions is None or k >= len(positions):
                raise EngineFailure(
                    f"{self.engine_id}: result for unknown request_id "
                    f"{res.request_id!r}")
            taken[res.request_id] = k + 1
            keyed.append((positions[k], res))
        keyed.sort(key=lambda t: t[0])
        return [res for _, res in keyed]

    def hosted_models(self) -> List[str]:
        return [self.arch]

    def capacity_hint(self) -> int:
        """Preferred per-dispatch batch size (scheduler right-sizing).
        The continuous backend absorbs oversized batches through per-step
        admission, so it advertises a deeper queue."""
        if self._batcher is not None:
            return self.max_batch * 4
        return self.max_batch

    def backend_stats(self) -> Dict[str, Any]:
        """Decode-backend telemetry."""
        d: Dict[str, Any] = {"backend": self.backend}
        if self._batcher is not None:
            d.update(self._batcher.stats())
        return d
