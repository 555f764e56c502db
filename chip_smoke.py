#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
(K1 decode attention, K2 flash attention, K3 similarity top-k, K4 RG-LRU
scan, K5 RWKV-6 scan), holds each against its plain PyTorch version on the
card, serves one mixed batch (SCORE, COMPLETE, CLASSIFY, EMBED) with
proxy-8b at full width (32 layers, d_model 4096, vocab 128256, bf16,
random weights from a seed), checks that the served path launched each
kernel the expected number of times and that its results are well formed,
holds what goes through the kernels (every decode step's logits,
CLASSIFY's label logprobs, EMBED's vectors) to the same computed through
the plain attention, then drives the semantic index over the same engine
(CortexClient -> RequestPipeline -> Scheduler -> EMBED ->
SemanticIndexManager -> IvfFlatIndex -> the similarity top-k kernel) and
holds its searches to a plain-path manager over the same store.  Then it
serves the same mix with rwkv6-1.6b (24 RWKV-6 blocks, d_model 2048, every
wkv scan through K5) and recurrentgemma-9b (38 RG-LRU and local-attention
layers, d_model 4096, vocab 256000: RG-LRU scans through K4, the
sliding-window attention through K2 and K1 at head dim 256), both at full
width and depth on the engine's static path, with the same gates against
their plain paths (every scan and attention through its plain version).
Last it times each kernel beside its plain version, its bound and, where
one exists, one PyTorch library call.  The last line is a JSON object with
``"ok": true``; any failed check exits non-zero without it.  It needs no
network and imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
# dense, per type; "tf32": the tensor cores' TF32 product rate (K3)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
TOL = {"bfloat16": 5e-2, "float32": 2e-4}  # the tolerances of the CPU tests
# kernel-served vs plain-served limits at full width (bf16), a few times
# the readings on the H100 (PERF.md, section 6): decode-step logits
# (relative L2 per row), SCORE's prefill logits (the same, static path
# only), CLASSIFY label logprobs (nats), EMBED cosine (lower limit)
SERVE_TOL = {
    "proxy-8b": {"decode_logits_rel": 0.05, "classify_logprob": 0.05,
                 "embed_cosine": 0.9995},
    "rwkv6-1.6b": {"decode_logits_rel": 0.05, "score_logits_rel": 0.1,
                   "classify_logprob": 0.05, "embed_cosine": 0.9995},
    "recurrentgemma-9b": {"decode_logits_rel": 0.08,
                          "score_logits_rel": 0.08,
                          "classify_logprob": 0.05, "embed_cosine": 0.9995},
}
# K3 (similarity top-k, fp32): values within TOPK_TOL of the plain
# version; ids equal except between rows whose plain scores lie within
# TOPK_TOL of each other (fp32 sums in another order); on sign vectors,
# where every score is exact, ids equal with no exception
TOPK_TOL = 1e-5
SEED = 0
N_LAYERS = 32
# each kernel's source and the TPU kernel it replaces
KERNEL_FILES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:74"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:86"),
    "similarity_topk": ("src/repro_torch/kernels/csrc/similarity_topk.cu",
                        "src/repro/kernels/similarity_topk/kernel.py:69"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:46"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan/kernel.py:55"),
}

PROMPTS_SCORE = [
    "Is the following review positive? 'The film was a delight from start "
    "to finish.'",
    "Does this ticket describe a billing problem? 'I was charged twice for "
    "my March invoice.'",
    "Is this sentence about sports? 'The striker scored twice in the final "
    "minutes.'",
    "Is the product in this listing a laptop? 'Ultra-thin 14-inch notebook, "
    "16 GB RAM, 1 TB SSD.'",
    "Does the email ask for a meeting? 'Could we find thirty minutes on "
    "Thursday to go over the plan?'",
    "Is this headline about the weather? 'Heavy snow expected across the "
    "north this weekend.'",
    "Is the customer angry? 'This is the third time the order has arrived "
    "broken and nobody answers.'",
    "Does the abstract mention a database? 'We present a query optimizer "
    "for semantic operators in SQL.'",
]
PROMPTS_COMPLETE = [
    "Summarize in one sentence: the quarterly report shows revenue up 12% "
    "while costs stayed flat.",
    "Translate to French: the library opens at nine in the morning.",
    "Write a short product title for a stainless steel water bottle.",
    "Continue the list of primary colours: red, blue,",
]
PROMPTS_CLASSIFY = [
    ("Classify the sentiment of: 'The battery died after one day.'",
     ("positive", "negative", "neutral")),
    ("Which department should handle: 'My password reset link expired.'",
     ("billing", "support", "sales")),
]
PROMPTS_EMBED = [
    "Wireless noise-cancelling headphones with a 30-hour battery.",
    "A comparison of columnar storage formats for analytical queries.",
]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 20):
    """The kernels' own time per call from the profiler: for each kernel
    ``fn`` launches once a call, its mean device time a launch, summed.
    Where a call is short, the events of ``cuda_time_ms`` time the host's
    launches instead.  Averaged over the launches recorded, not over
    ``iters``: a profiler session after an earlier one in the same process
    may not record every launch.  None where it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total / e.count for e in prof.key_averages()
             if e.self_device_time_total > 0 and e.count)
    return us / 1e3 if us else None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def max_err(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


# ---------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once, and the
# operations these inputs need (valid keys only), whichever takes longer
# ---------------------------------------------------------------------------


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_bound(q, kc, lengths):
    B, _, H, hd = q.shape
    KV = kc.shape[2]
    es = q.element_size()
    keys = int(lengths.clamp(0, kc.shape[1]).sum())
    nbytes = (2 * B * H * hd * es             # q in, out
              + 2 * keys * KV * hd * es       # valid K and V rows
              + 4 * B + 4 * B * H)            # lengths, lse
    ops = 4.0 * keys * H * hd                 # q.k and p.v
    return bound(nbytes, ops, str(q.dtype).split(".")[-1])


def rwkv_bound(r):
    """K5: r, k, v read in their type, w read and o written in fp32, u,
    s0 and sT in fp32; 5 hd^2 operations a step per (row, head)."""
    B, S, H, hd = r.shape
    n = B * S * H * hd
    nbytes = (3 * r.element_size() * n + 4 * n + 4 * n   # r,k,v; w; o
              + 4 * H * hd + 2 * 4 * B * H * hd * hd)   # u; s0, sT
    return bound(nbytes, 5.0 * n * hd, "float32")


def flash_bound(q, k, causal, window):
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    pairs = 0
    for i in range(Sq):
        qp = i + Skv - Sq
        hi = min(qp, Skv - 1) if causal else Skv - 1
        lo = max(0, qp - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    nbytes = es * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd)
    ops = 4.0 * B * H * hd * pairs
    return bound(nbytes, ops, str(q.dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_kernels(*kernel_ops):
    t0 = time.perf_counter()
    libs = [m.LIB for m in kernel_ops]
    with ThreadPoolExecutor(len(libs)) as pool:     # one nvcc per source
        list(pool.map(lambda lib: lib.load(), libs))
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          + " + ".join(lib.source.name for lib in libs)
          + " (nvcc, sm_90a, in parallel)")
    for lib in libs:
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {lib.source.name}: {lib.build_seconds:.1f} s, ptxas: "
              + " | ".join(sorted(set(regs))[:6]))


def check_kernels(torch, dec_ops, flash_ops, dev):
    """Each kernel against its plain version at the serving model's
    attention widths, bf16 and fp32; returns the max error per kernel."""
    H, KV, hd = 32, 8, 128
    errs = {"decode_attention": 0.0, "flash_attention": 0.0}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        B, Smax = 8, 512
        q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dtype)
        kc = torch.randn((B, Smax, KV, hd), generator=gen,
                         device=dev).to(dtype)
        vc = torch.randn((B, Smax, KV, hd), generator=gen,
                         device=dev).to(dtype)
        lengths = torch.tensor([1, 31, 33, 200, 512, 64, 65, 500],
                               dtype=torch.int32, device=dev)
        out, lse = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
        ref, ref_lse = dec_ops.flash_decode(q, kc, vc, lengths,
                                            impl="reference",
                                            return_lse=True)
        torch.cuda.synchronize()
        e, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        print(f"K1 decode {name} B={B} H={H} KV={KV} hd={hd} Smax={Smax} "
              f"lengths={lengths.tolist()}: max|out-plain|={e:.3g} "
              f"max|lse-plain|={e_lse:.3g} (tol {TOL[name]})")
        if not (e <= TOL[name] and e_lse <= TOL["float32"]):
            fail(f"K1 {name} disagrees with its plain version")
        errs["decode_attention"] = max(errs["decode_attention"], e)
        for Sq, Skv, window in ((1, 1, 0), (37, 37, 0), (128, 128, 0),
                                (384, 384, 0), (384, 384, 64),
                                (128, 384, 0)):
            B = 2
            q = torch.randn((B, Sq, H, hd), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((B, Skv, KV, hd), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((B, Skv, KV, hd), generator=gen,
                            device=dev).to(dtype)
            out = flash_ops.flash_attention(q, k, v, window=window)
            ref = flash_ops.flash_attention(q, k, v, window=window,
                                            impl="reference")
            torch.cuda.synchronize()
            e = max_err(out, ref)
            print(f"K2 flash {name} B={B} H={H} KV={KV} hd={hd} Sq={Sq} "
                  f"Skv={Skv} causal window={window}: max|out-plain|="
                  f"{e:.3g} (tol {TOL[name]})")
            if not e <= TOL[name]:
                fail(f"K2 {name} Sq={Sq} Skv={Skv} window={window} "
                     "disagrees with its plain version")
            errs["flash_attention"] = max(errs["flash_attention"], e)
    check_attention_hd256(torch, dec_ops, flash_ops, dev, gen, errs)
    return errs


def check_attention_hd256(torch, dec_ops, flash_ops, dev, gen, errs):
    """K1 and K2 at recurrentgemma's local-attention widths (16 q heads on
    one kv head, hd 256): K1 over a 2048-slot ring at the ring lengths a
    decode step gives (a prefix of min(pos + 1, 2048) slots), K2 in window
    mode with the window shorter and longer than the sequence."""
    H, KV, hd = 16, 1, 256
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]

        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        B, W = 8, 2048
        q, kc, vc = r(B, 1, H, hd), r(B, W, KV, hd), r(B, W, KV, hd)
        lengths = torch.tensor([1, 33, 64, 65, 384, 1000, 2047, 2048],
                               dtype=torch.int32, device=dev)
        out, lse = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
        ref, ref_lse = dec_ops.flash_decode(q, kc, vc, lengths,
                                            impl="reference",
                                            return_lse=True)
        torch.cuda.synchronize()
        e, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        print(f"K1 decode {name} B={B} H={H} KV={KV} hd={hd} ring {W} "
              f"lengths={lengths.tolist()}: max|out-plain|={e:.3g} "
              f"max|lse-plain|={e_lse:.3g} (tol {TOL[name]})")
        if not (e <= TOL[name] and e_lse <= TOL["float32"]):
            fail(f"K1 {name} hd {hd} disagrees with its plain version")
        errs["decode_attention@hd256"] = max(
            errs.get("decode_attention@hd256", 0.0), e)
        for S, window in ((37, 16), (128, 2048), (384, 2048), (384, 100)):
            B = 2
            q, k, v = r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)
            out = flash_ops.flash_attention(q, k, v, window=window)
            ref = flash_ops.flash_attention(q, k, v, window=window,
                                            impl="reference")
            torch.cuda.synchronize()
            e = max_err(out, ref)
            print(f"K2 flash {name} B={B} H={H} KV={KV} hd={hd} S={S} "
                  f"window={window}: max|out-plain|={e:.3g} (tol "
                  f"{TOL[name]})")
            if not e <= TOL[name]:
                fail(f"K2 {name} hd {hd} S={S} window={window} disagrees "
                     "with its plain version")
            errs["flash_attention@hd256"] = max(
                errs.get("flash_attention@hd256", 0.0), e)


def decays(torch, gen, shape, dev):
    """Decays in (0, 1), as the models make them."""
    return torch.sigmoid(torch.randn(shape, generator=gen, device=dev) + 2)


def rel_err(x, ref) -> float:
    """max |x - ref| over max(1, max |ref|): K5's state and outputs grow
    with the sequence, and fp32 rounding with them."""
    return max_err(x, ref) / max(1.0, float(ref.abs().max()))


def check_scans(torch, rglru_ops, rwkv_ops, dev, errs):
    """K4 and K5 against their plain versions, bf16 and fp32 inputs, at
    the served models' widths (K4: W = 4096; K5: 32 heads of 64) and the
    full shapes (B = 8, S = 384), a served decode step (S = 1) and odd
    sizes, K5 also with decays that underflow to 0; K5 also chained: two launches over the halves, the second from
    the first's state, equal one launch over the whole.  K4 must give the
    plain version's bits (both round the multiply and the add apart);
    K5 within TOL["float32"] relative to the largest plain value."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs.setdefault("rglru_scan", 0.0)
    errs.setdefault("rwkv6_scan", 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for B, S, W in ((8, 384, 4096), (8, 45, 4096), (3, 37, 300)):
            a = decays(torch, gen, (B, S, W), dev).to(dtype)
            b = torch.randn((B, S, W), generator=gen, device=dev).to(dtype)
            h0 = torch.randn((B, W), generator=gen, device=dev)
            hs, hT = rglru_ops.rglru_scan(a, b, h0)
            ref_hs, ref_hT = rglru_ops.rglru_scan(a, b, h0, impl="reference")
            torch.cuda.synchronize()
            e = max(max_err(hs, ref_hs), max_err(hT, ref_hT))
            same = torch.equal(hs, ref_hs) and torch.equal(hT, ref_hT)
            print(f"K4 rglru {name} B={B} S={S} W={W}: max|h-plain|={e:.3g}"
                  f", bitwise equal {same}")
            if not same:
                fail(f"K4 {name} B={B} S={S} W={W} differs from its plain "
                     "version")
            errs["rglru_scan"] = max(errs["rglru_scan"], e)
        for B, S, H, hd, small in ((8, 384, 32, 64, False),
                                   (8, 45, 32, 64, False),
                                   (8, 1, 32, 64, False),
                                   (3, 37, 5, 64, False),
                                   (2, 19, 3, 16, False),
                                   (8, 385, 32, 64, True)):
            r, k, v = (torch.randn((B, S, H, hd), generator=gen,
                                   device=dev).to(dtype) for _ in range(3))
            if small:       # w = exp(-exp(x)), x up to 5: some w are 0
                x = torch.randn((B, S, H, hd), generator=gen, device=dev)
                w = torch.exp(-torch.exp((2 * x + 1).clamp(-6, 5)))
            else:
                w = decays(torch, gen, (B, S, H, hd), dev)
            u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
            s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev)
            o, sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
            again = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
            ref_o, ref_sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0,
                                                impl="reference")
            torch.cuda.synchronize()
            e = max(rel_err(o, ref_o), rel_err(sT, ref_sT))
            msg = ""
            if S > 1:
                h = S // 2
                o1, s1 = rwkv_ops.rwkv6_scan(r[:, :h], k[:, :h], v[:, :h],
                                             w[:, :h], u, s0)
                o2, s2 = rwkv_ops.rwkv6_scan(r[:, h:], k[:, h:], v[:, h:],
                                             w[:, h:], u, s1)
                e_chain = max(rel_err(torch.cat([o1, o2], 1), o),
                              rel_err(s2, sT))
                msg = f", two halves chained vs one launch {e_chain:.3g}"
                e = max(e, e_chain)
            repeat = (torch.equal(again[0], o)
                      and torch.equal(again[1], sT))
            e_abs = max(max_err(o, ref_o), max_err(sT, ref_sT))
            finite = bool(torch.isfinite(o).all() and torch.isfinite(sT).all())
            print(f"K5 rwkv6 {name} B={B} S={S} H={H} hd={hd}"
                  f"{' (decays down to 0)' if small else ''}: rel. max|"
                  f"err| vs plain {e:.3g} (tol {TOL['float32']}), max|err| "
                  f"{e_abs:.3g}{msg}, repeat bitwise equal {repeat}, "
                  f"finite {finite}")
            if not (e <= TOL["float32"] and repeat and finite):
                fail(f"K5 {name} B={B} S={S} H={H} disagrees with its plain "
                     "version or with itself")
            errs["rwkv6_scan"] = max(errs["rwkv6_scan"], e_abs)


def requests(arch="proxy-8b"):
    from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED,
                                               SCORE, Request)
    reqs = [Request(p, arch, SCORE) for p in PROMPTS_SCORE]
    reqs += [Request(p, arch, COMPLETE, max_tokens=16)
             for p in PROMPTS_COMPLETE]
    reqs += [Request(p, arch, CLASSIFY, labels=lbls)
             for p, lbls in PROMPTS_CLASSIFY]
    reqs += [Request(p, arch, EMBED, metadata={"embed_dim": 256})
             for p in PROMPTS_EMBED]
    for i, r in enumerate(reqs):
        r.request_id = i + 1
    return reqs


def check_results(reqs, results):
    from repro_torch.inference.backend import CLASSIFY, COMPLETE, EMBED, SCORE
    if len(results) != len(reqs):
        fail(f"{len(results)} results for {len(reqs)} requests")
    for r, res in zip(reqs, results):
        if res.request_id != r.request_id or res.kind != r.kind:
            fail(f"result {res.request_id}/{res.kind} out of order")
        if res.tokens_in <= 0 or not res.credits > 0:
            fail(f"request {r.request_id}: not metered")
        if r.kind == SCORE and not (0.0 <= res.score <= 1.0
                                    and math.isfinite(res.score)):
            fail(f"request {r.request_id}: score {res.score}")
        if r.kind == COMPLETE and not (
                1 <= res.tokens_out <= r.max_tokens
                and isinstance(res.text, str)):
            fail(f"request {r.request_id}: {res.tokens_out} tokens out")
        if r.kind == CLASSIFY and res.label not in r.labels:
            fail(f"request {r.request_id}: label {res.label!r}")
        if r.kind == EMBED:
            v = res.embedding
            n = math.sqrt(sum(x * x for x in v))
            if len(v) != 256 or not abs(n - 1.0) < 1e-4:
                fail(f"request {r.request_id}: embedding norm {n}")


class Spy:
    """Wraps ``owner.name``, passing every call through, and hands each
    call's arguments and result to ``record(args, kw, out)``."""

    def __init__(self, owner, name, record):
        self.owner, self.name, self.record = owner, name, record

    def __enter__(self):
        orig = self.orig = getattr(self.owner, self.name)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            self.record(args, kw, out)
            return out
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def first_launch_per_pass(pass_of):
    """A Spy recorder keeping the inputs of the first kernel launch of each
    model pass (the layers of one pass share ``pass_of(args)``) in
    ``passes``.  The served path never writes to a tensor after handing it
    to a kernel, so references suffice."""
    passes = []

    def record(args, kw, out):
        key = pass_of(args)
        if not passes or passes[-1][0] != key:
            passes.append((key, args, kw))
    return passes, record


def step_logits(batcher, tables, lens, cur, impl):
    """The logits of one continuous-batcher decode step with single-token
    attention ``impl``, on a gathered copy of the paged KV (the pool is
    left as it was)."""
    from repro_torch.models import attention
    params = batcher.engine.params
    cache = batcher.kv.gather(batcher.kv.pool, tables, lens)
    with attention.use_decode_impl(impl):
        out = batcher.model.apply(params, {"tokens": cur}, mode="decode",
                                  cache=cache)
    return batcher.model.logits_of(params, out["hidden"][:, 0])


def serve_and_check(torch, eng, errs):
    """Serve the mixed batch on the kernel path (counting launches, timing
    steps), re-serve it through the plain attention, gate on both, and time
    each kernel at the served inputs with the most work.  Returns the rows
    of the kernels line."""
    from repro_torch.inference import tokenizer as tok
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention
    cfg = eng.cfg
    reqs = requests()
    # warm-up: the first calls pay for cuBLAS handles and allocator growth
    eng.submit_batch(reqs[:1] + reqs[-1:])
    batcher = eng._batcher
    step_ms = []
    prefill_ms = []
    orig_decode, orig_prefill = batcher._decode_fn, batcher._prefill_fn

    def timed(fn, sink):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    batcher._decode_fn = timed(orig_decode, step_ms)
    batcher._prefill_fn = timed(orig_prefill, prefill_ms)
    before = eng.backend_stats()
    k1_passes, k1_record = first_launch_per_pass(lambda a: id(a[3]))
    k2_passes, k2_record = first_launch_per_pass(lambda a: tuple(a[0].shape))
    ids, lps = [], []
    dec_ops.LAUNCHES = 0
    flash_ops.LAUNCHES = 0
    with Spy(dec_ops, "decode_attention_cuda", k1_record), \
            Spy(flash_ops, "flash_attention_cuda", k2_record), \
            Spy(eng, "_sequence_logprob",
                lambda a, kw, out: lps.extend(out[0])), \
            Spy(tok, "decode", lambda a, kw, out: ids.append(list(a[0]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.submit_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"decode_attention": dec_ops.LAUNCHES,
                "flash_attention": flash_ops.LAUNCHES}
    batcher._decode_fn, batcher._prefill_fn = orig_decode, orig_prefill
    after = eng.backend_stats()
    check_results(reqs, results)
    decode_steps = after["decode_steps"] - before["decode_steps"]
    prefill_tokens = after["prefill_tokens"] - before["prefill_tokens"]
    n_cls = sum(r.kind == "classify" for r in reqs)
    n_emb = sum(r.kind == "embed" for r in reqs)
    passes = -(-n_cls // eng.max_batch) + -(-n_emb // eng.max_batch)
    expect = {"decode_attention": cfg.num_layers * decode_steps,
              "flash_attention": cfg.num_layers * passes}
    print(f"served {len(reqs)} requests in {wall:.3f} s: {decode_steps} "
          f"decode steps, {len(prefill_ms)} chunked-prefill steps "
          f"({prefill_tokens} prompt tokens), {passes} full-sequence passes")
    print(f"launches: {launches}, expected {expect}")
    if launches != expect or min(launches.values()) == 0:
        fail("kernel launch counts differ from the served path's steps")
    med_step = statistics.median(step_ms) if step_ms else float("nan")
    print(f"decode step: median {med_step:.3f} ms over {len(step_ms)} steps "
          f"(B={eng.max_batch} slots); chunked prefill "
          f"{prefill_tokens / (sum(prefill_ms) / 1e3):.1f} tokens/s over "
          f"{len(prefill_ms)} steps")

    # 4. re-serve through the plain attention on the same weights, and hold
    #    what went through the kernels to it: each decode step's logits
    #    (K1, both attentions on the same step state), CLASSIFY's label
    #    logprobs and EMBED's vectors (K2).  SCORE is chunked prefill only
    #    on this backend and launches no kernel.
    probe = []            # per decode step: rel. L2 error, max |err|, top-1
    ref_ids, ref_lps = [], []

    def probed(tables, lens, act, cur):
        rows = act.bool()
        lk = step_logits(batcher, tables, lens, cur, "auto")[rows]
        lp = step_logits(batcher, tables, lens, cur, "reference")[rows]
        rel = ((lk - lp).norm(dim=-1) / lp.norm(dim=-1)).max()
        same = (lk.argmax(-1) == lp.argmax(-1)).sum()
        probe.append((float(rel), max_err(lk, lp), int(same), int(rows.sum())))
        return orig_decode(tables, lens, act, cur)

    batcher.decode_impl = "reference"
    batcher._decode_fn = probed
    with attention.use_flash_impl("reference"), \
            Spy(eng, "_sequence_logprob",
                lambda a, kw, out: ref_lps.extend(out[0])), \
            Spy(tok, "decode",
                lambda a, kw, out: ref_ids.append(list(a[0]))):
        ref_results = eng.submit_batch(reqs)
    batcher._decode_fn = orig_decode
    batcher.decode_impl = "auto"
    check_results(reqs, ref_results)
    logits_rel = max(p[0] for p in probe)
    logits_abs = max(p[1] for p in probe)
    top1 = (sum(p[2] for p in probe), sum(p[3] for p in probe))
    d_lp = max(abs(a - b) for a, b in zip(lps, ref_lps))
    cos = min(sum(x * y for x, y in zip(a.embedding, b.embedding))
              for a, b in zip(results, ref_results) if a.kind == "embed")
    agree = []            # matching leading tokens / tokens generated
    for a, b in zip(ids, ref_ids):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        agree.append(f"{n}/{max(len(a), len(b))}")
    same_label = sum(a.label == b.label for a, b in zip(results, ref_results)
                     if a.kind == "classify")
    tol = SERVE_TOL["proxy-8b"]
    print(f"kernel vs plain, K1: decode-step logits over {len(probe)} steps "
          f"max rel. L2 err {logits_rel:.3g} (tol "
          f"{tol['decode_logits_rel']}), max |err| {logits_abs:.3g}, "
          f"same top-1 token {top1[0]}/{top1[1]} rows")
    print(f"kernel vs plain, K2: CLASSIFY label logprobs {len(lps)} pairs "
          f"max |err| {d_lp:.3g} nats (tol {tol['classify_logprob']}), "
          f"labels same {same_label}/{n_cls}; EMBED min cosine {cos:.6f} "
          f"(tol {tol['embed_cosine']})")
    print(f"COMPLETE leading tokens equal {agree} (not gated: greedy argmax "
          "over near-flat random logits can flip on bf16 rounding)")
    if len(lps) != len(ref_lps) or not lps or not probe:
        fail("the served path ran no CLASSIFY pass or no decode step")
    if not (logits_rel <= tol["decode_logits_rel"]
            and d_lp <= tol["classify_logprob"]
            and cos >= tol["embed_cosine"]):
        fail("the kernel-served and plain-served results disagree")

    # 5. profile one served batch: device busy share and top kernels
    profile_served(torch, eng, reqs)

    # 6. time each kernel at the served inputs with the most work (K1: the
    #    decode step with the most valid keys; K2: the largest pass) and at
    #    the model's long shapes, beside its plain version, its bound and
    #    SDPA
    if not k1_passes or not k2_passes:
        fail("the served path launched a kernel no time")
    k1_keys = [int(a[3].clamp(max=a[1].shape[1]).sum())
               for _, a, _ in k1_passes]
    k1_served = k1_passes[k1_keys.index(max(k1_keys))]
    k2_served = max(k2_passes, key=lambda p: math.prod(p[0]))
    rows = []
    for name, (_, args, kw) in (("decode_attention", k1_served),
                                ("flash_attention", k2_served)):
        t = (time_decode(torch, dec_ops, *args) if name == "decode_attention"
             else time_flash(torch, flash_ops, *args, **kw))
        err = gate_err(name, t.pop("max_abs_err"), args[0].dtype)
        errs[name] = max(errs[name], err)
        rows.append(kernel_row(name, launches[name], errs[name], t))
    return rows


def gate_err(name, err, dtype):
    """Fail unless a timed launch agreed with its plain version."""
    tol = TOL[str(dtype).split(".")[-1]]
    if not err <= tol:
        fail(f"{name} disagrees with its plain version on the timed "
             f"inputs: {err} > {tol}")
    return err


# ---------------------------------------------------------------------------
# rwkv6-1.6b and recurrentgemma-9b on the engine's static path (K5; K4, K2
# and K1 at hd 256)
# ---------------------------------------------------------------------------


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


@contextlib.contextmanager
def kernel_impls(impl):
    """Every kernel of the model path at ``impl``: "auto" launches the
    kernels, "reference" runs their plain versions."""
    from repro_torch.models import attention, blocks
    with attention.use_flash_impl(impl), attention.use_decode_impl(impl), \
            blocks.use_scan_impl(impl):
        yield


def rel_rows(a, b) -> float:
    """Largest relative L2 error of a row of ``a`` against ``b``."""
    return float(((a.float() - b.float()).norm(dim=-1)
                  / b.float().norm(dim=-1)).max())


def serve_static(torch, arch, kernels, per_pass, per_step):
    """Serve the mixed batch with ``arch`` at full width on the static
    path through the kernels, then through their plain versions, and gate
    on launch counts, well-formed results and kernel-vs-plain agreement
    (SCORE prefill logits, decode-step logits on the same state, CLASSIFY
    logprobs, EMBED cosine).  ``kernels`` maps each kernel name to
    (ops module, wrapper name); ``per_pass`` / ``per_step`` give its
    launches per full-sequence pass and per decode step.  Returns the
    engine, the requests and the first launch of each kernel in each
    pass: {name: [(args, kwargs), ...]}."""
    from repro_torch.inference.engine import TorchInferenceEngine
    from repro_torch.inference import tokenizer as tok
    t0 = time.perf_counter()
    eng = TorchInferenceEngine(arch, smoke=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"engine: {cfg.name} {cfg.num_layers} layers "
          f"({'+'.join(cfg.period)} x {cfg.num_periods}"
          f"{' + ' + '+'.join(cfg.tail) if cfg.tail else ''}) d_model "
          f"{cfg.d_model} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
          f"{cfg.dtype}, {n_params / 1e9:.2f} B params, backend "
          f"{eng.backend}, built in {time.perf_counter() - t0:.1f} s; "
          "depth not cut")
    if eng.backend != "static":
        fail(f"{arch} is not on the static path")
    reqs = requests(arch)
    eng.submit_batch(reqs[:1] + reqs[-1:])          # warm-up
    model = eng.model
    modes = []
    step_ms = []

    def counted(params, batch, *, mode, cache=None):
        modes.append(mode)                  # launches below key on len()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.apply(params, batch, mode=mode, cache=cache)
        torch.cuda.synchronize()
        if mode == "decode":
            step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    first = {}
    spies = []
    for name, (mod, fn) in kernels.items():
        first[name], rec = first_launch_per_pass(lambda a: len(modes))
        spies.append(Spy(mod, fn, rec))
        mod.LAUNCHES = 0
    lps, scores, ids = [], [], []
    eng.model = dataclasses.replace(model, apply=counted)
    try:
        with contextlib.ExitStack() as stack:
            for spy in spies:
                stack.enter_context(spy)
            stack.enter_context(Spy(eng, "_sequence_logprob",
                                    lambda a, kw, out: lps.extend(out[0])))
            stack.enter_context(Spy(eng, "_prefill",
                                    lambda a, kw, out: scores.append(out[0])))
            stack.enter_context(Spy(tok, "decode",
                                    lambda a, kw, out: ids.append(list(a[0]))))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eng.submit_batch(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        eng.model = model
    launches = {name: mod.LAUNCHES for name, (mod, _) in kernels.items()}
    check_results(reqs, results)
    passes = sum(m != "decode" for m in modes)
    steps = sum(m == "decode" for m in modes)
    expect = {name: per_pass[name] * passes + per_step[name] * steps
              for name in kernels}
    med = statistics.median(step_ms) if step_ms else float("nan")
    print(f"{arch} served {len(reqs)} requests in {wall:.3f} s: {passes} "
          f"full-sequence passes, {steps} decode steps (median "
          f"{med:.3f} ms)")
    print(f"{arch} launches: {launches}, expected {expect}")
    if launches != expect or min(launches.values()) == 0:
        fail(f"{arch}: kernel launch counts differ from the served path's "
             "passes and steps")

    # the same batch through the plain versions; each decode step's
    # logits computed both ways on copies of the same state
    probe = []
    ref_lps, ref_scores, ref_ids = [], [], []

    def probed(params, batch, *, mode, cache=None):
        if mode == "decode":
            with kernel_impls("auto"):
                hk = model.apply(params, batch, mode=mode,
                                 cache=clone_tree(cache))["hidden"]
            hp = model.apply(params, batch, mode=mode,
                             cache=clone_tree(cache))["hidden"]
            lk = model.logits_of(params, hk[:, 0])
            lp = model.logits_of(params, hp[:, 0])
            probe.append((rel_rows(lk, lp), max_err(lk, lp),
                          int((lk.argmax(-1) == lp.argmax(-1)).sum()),
                          lk.shape[0]))
        return model.apply(params, batch, mode=mode, cache=cache)

    eng.model = dataclasses.replace(model, apply=probed)
    try:
        with kernel_impls("reference"), \
                Spy(eng, "_sequence_logprob",
                    lambda a, kw, out: ref_lps.extend(out[0])), \
                Spy(eng, "_prefill",
                    lambda a, kw, out: ref_scores.append(out[0])), \
                Spy(tok, "decode",
                    lambda a, kw, out: ref_ids.append(list(a[0]))):
            ref_results = eng.submit_batch(reqs)
    finally:
        eng.model = model
    check_results(reqs, ref_results)
    tol = SERVE_TOL[arch]
    if (len(lps) != len(ref_lps) or not lps or not probe
            or len(scores) != len(ref_scores)):
        fail(f"{arch}: the served path ran no CLASSIFY pass or no decode "
             "step, or the two runs prefilled differently")
    score_rel = max(rel_rows(a, b) for a, b in zip(scores, ref_scores))
    logits_rel = max(p[0] for p in probe)
    logits_abs = max(p[1] for p in probe)
    top1 = (sum(p[2] for p in probe), sum(p[3] for p in probe))
    d_lp = max(abs(a - b) for a, b in zip(lps, ref_lps))
    cos = min(sum(x * y for x, y in zip(a.embedding, b.embedding))
              for a, b in zip(results, ref_results) if a.kind == "embed")
    d_score = max(abs(a.score - b.score) for a, b in
                  zip(results, ref_results) if a.kind == "score")
    agree = []
    for a, b in zip(ids, ref_ids):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        agree.append(f"{n}/{max(len(a), len(b))}")
    print(f"{arch} kernel vs plain: prefill logits over {len(scores)} "
          f"passes max rel. L2 err {score_rel:.3g} (tol "
          f"{tol['score_logits_rel']}), SCORE max |diff| {d_score:.3g}; "
          f"decode-step logits over {len(probe)} steps max rel. L2 err "
          f"{logits_rel:.3g} (tol {tol['decode_logits_rel']}), max |err| "
          f"{logits_abs:.3g}, same top-1 token {top1[0]}/{top1[1]} rows")
    print(f"{arch} kernel vs plain: CLASSIFY label logprobs {len(lps)} "
          f"pairs max |err| {d_lp:.3g} nats (tol "
          f"{tol['classify_logprob']}); EMBED min cosine {cos:.6f} (tol "
          f"{tol['embed_cosine']}); COMPLETE leading tokens equal {agree} "
          "(not gated)")
    if not (score_rel <= tol["score_logits_rel"]
            and logits_rel <= tol["decode_logits_rel"]
            and d_lp <= tol["classify_logprob"]
            and cos >= tol["embed_cosine"]):
        fail(f"{arch}: the kernel-served and plain-served results disagree")
    profile_served(torch, eng, reqs)
    return eng, {name: [(a, kw) for _, a, kw in first[name]]
                 for name in kernels}, launches


def most_work(calls, work):
    """The launch among ``calls`` with the most ``work(args)``."""
    return max(calls, key=lambda c: work(c[0]))


def kernel_row(name, launches, err, t, **extra):
    """A row of the kernels line for ``name`` (a key of KERNEL_FILES)."""
    src, tpu = KERNEL_FILES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": err, **t, **extra}


def time_rglru(torch, rglru_ops, what, a, b, h0, iters=50):
    out = rglru_ops.rglru_scan_cuda(a, b, h0)
    ref = rglru_ops.rglru_scan(a, b, h0, impl="reference")
    err = max(max_err(out[0], ref[0]), max_err(out[1], ref[1]))
    if err != 0.0:
        fail(f"K4 {what}: differs from its plain version by {err}")
    B, S, W = a.shape
    ms = cuda_time_ms(lambda: rglru_ops.rglru_scan_cuda(a, b, h0), iters)
    plain_ms = cuda_time_ms(lambda: rglru_ops.rglru_scan(
        a, b, h0, impl="reference"), 3, warmup=1)
    es = a.element_size()
    nbytes = 2 * es * B * S * W + 4 * (B * S * W + 2 * B * W)
    b_ms, b_by = bound(nbytes, 2.0 * B * S * W, "float32")
    print(f"time K4 rglru {what} B={B} S={S} W={W} "
          f"{str(a.dtype).split('.')[-1]}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library none, bound {b_ms:.5f} ms ({b_by}); "
          f"max|err| {err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err}


def time_rwkv(torch, rwkv_ops, what, r, k, v, w, u, s0, iters=20):
    out = rwkv_ops.rwkv6_scan_cuda(r, k, v, w, u, s0)
    ref = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0, impl="reference")
    err = max(max_err(out[0], ref[0]), max_err(out[1], ref[1]))
    rel = max(rel_err(out[0], ref[0]), rel_err(out[1], ref[1]))
    if not rel <= TOL["float32"]:
        fail(f"K5 {what}: relative error {rel} against its plain version")
    B, S, H, hd = r.shape
    ms = cuda_time_ms(lambda: rwkv_ops.rwkv6_scan_cuda(r, k, v, w, u, s0),
                      iters)
    plain_ms = cuda_time_ms(lambda: rwkv_ops.rwkv6_scan(
        r, k, v, w, u, s0, impl="reference"), 2, warmup=1)
    dev_ms = device_ms(lambda: rwkv_ops.rwkv6_scan_cuda(r, k, v, w, u, s0))
    b_ms, b_by = rwkv_bound(r)
    print(f"time K5 rwkv6 {what} B={B} S={S} H={H} hd={hd} "
          f"{str(r.dtype).split('.')[-1]}: kernel {ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, library none, bound "
          f"{b_ms:.5f} ms ({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "max_abs_err": err}


def rwkv_path(torch, errs):
    """rwkv6-1.6b served at full width; K5 timed at the served launch with
    the most work and at the full shape.  Returns K5's kernels-line row."""
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    L = 24
    eng, calls, launches = serve_static(
        torch, "rwkv6-1.6b", {"rwkv6_scan": (rwkv_ops, "rwkv6_scan_cuda")},
        {"rwkv6_scan": L}, {"rwkv6_scan": L})
    if eng.cfg.num_layers != L or eng.cfg.d_model != 2048:
        fail("rwkv6-1.6b is not at full width and depth")
    args, _ = most_work(calls["rwkv6_scan"], lambda a: a[0].numel())
    t = time_rwkv(torch, rwkv_ops, "served", *args)
    dev = args[0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    B, S, H, hd = 8, 384, 32, 64
    r, k, v = (torch.randn((B, S, H, hd), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    full = time_rwkv(torch, rwkv_ops, "full", r, k, v,
                     decays(torch, gen, (B, S, H, hd), dev),
                     torch.randn((H, hd), generator=gen, device=dev) * 0.1,
                     torch.zeros((B, H, hd, hd), device=dev))
    err = max(errs["rwkv6_scan"], t.pop("max_abs_err"),
              full.pop("max_abs_err"))
    errs["rwkv6_scan"] = err
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return [kernel_row("rwkv6_scan", launches["rwkv6_scan"], err, t,
                       path="rwkv6-1.6b", full_ms=full["ms"],
                       full_device_ms=full["device_ms"])]


def recurrentgemma_path(torch, errs):
    """recurrentgemma-9b served at full width; K4 and K2 / K1 at hd 256
    timed at the served launches with the most work and at the full
    shapes.  Returns their kernels-line rows."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    n_lru, n_local = 26, 12
    eng, calls, launches = serve_static(
        torch, "recurrentgemma-9b",
        {"rglru_scan": (rglru_ops, "rglru_scan_cuda"),
         "flash_attention": (flash_ops, "flash_attention_cuda"),
         "decode_attention": (dec_ops, "decode_attention_cuda")},
        {"rglru_scan": n_lru, "flash_attention": n_local,
         "decode_attention": 0},
        {"rglru_scan": 0, "flash_attention": 0, "decode_attention": n_local})
    cfg = eng.cfg
    if (cfg.num_layers != 38 or cfg.d_model != 4096
            or cfg.block_pattern.count("rglru") != n_lru
            or cfg.block_pattern.count("local") != n_local):
        fail("recurrentgemma-9b is not at full width and depth")
    rows = []
    a_args, _ = most_work(calls["rglru_scan"], lambda a: a[0].numel())
    t = time_rglru(torch, rglru_ops, "served", *a_args)
    dev = a_args[0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    B, S, W = 8, 384, 4096
    full = time_rglru(torch, rglru_ops, "full",
                      decays(torch, gen, (B, S, W), dev),
                      torch.randn((B, S, W), generator=gen, device=dev),
                      torch.zeros((B, W), device=dev))
    err = max(errs["rglru_scan"], t.pop("max_abs_err"),
              full.pop("max_abs_err"))
    errs["rglru_scan"] = err
    rows.append(kernel_row("rglru_scan", launches["rglru_scan"], err, t,
                           path="recurrentgemma-9b", full_ms=full["ms"]))

    def r(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    f_args, f_kw = most_work(calls["flash_attention"],
                             lambda a: a[0].numel())
    t = time_flash(torch, flash_ops, *f_args, **f_kw)
    full = time_flash(torch, flash_ops, r(8, 384, 16, 256),
                      r(8, 384, 1, 256), r(8, 384, 1, 256), window=2048,
                      iters=20)
    err = max(errs["flash_attention@hd256"],
              gate_err("K2", t.pop("max_abs_err"), f_args[0].dtype),
              gate_err("K2", full.pop("max_abs_err"), torch.bfloat16))
    rows.append(kernel_row("flash_attention", launches["flash_attention"],
                           err, t, path="recurrentgemma-9b",
                           full_ms=full["ms"],
                           full_device_ms=full["device_ms"]))
    d_args, _ = most_work(calls["decode_attention"],
                          lambda a: int(a[3].clamp(max=a[1].shape[1]).sum()))
    t = time_decode(torch, dec_ops, *d_args)
    full = time_decode(torch, dec_ops, r(8, 1, 16, 256), r(8, 2048, 1, 256),
                       r(8, 2048, 1, 256),
                       torch.full((8,), 2048, dtype=torch.int32, device=dev))
    err = max(errs["decode_attention@hd256"],
              gate_err("K1", t.pop("max_abs_err"), d_args[0].dtype),
              gate_err("K1", full.pop("max_abs_err"), torch.bfloat16))
    rows.append(kernel_row("decode_attention", launches["decode_attention"],
                           err, t, path="recurrentgemma-9b",
                           full_ms=full["ms"],
                           full_device_ms=full["device_ms"]))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# K3: similarity top-k, and the semantic index over the served engine
# ---------------------------------------------------------------------------


def topk_gate(torch, what, vals, idx, rv, ri, exact=False):
    """Hold K3's (vals, idx) [Q,k] to the plain version's (rv, ri), which
    carries one column more unless ``exact``.  Prints each id flip with
    its margin and fails on a flip outside TOPK_TOL (any flip if
    ``exact``) or a value off by more; returns max |value error|."""
    from repro_torch.kernels.similarity_topk.ref import topk_flips
    vals, idx, rv, ri = (torch.as_tensor(x).cpu() for x in (vals, idx, rv,
                                                           ri))
    k = idx.shape[1]
    want = rv[:, :k].double()
    both_inf = torch.isinf(want) & (vals.double() == want)
    err = torch.where(both_inf, torch.zeros_like(want),
                      (vals.double() - want).abs())
    err = float(err.max()) if err.numel() else 0.0
    flips = topk_flips(idx, rv, ri)
    for r, pos, got, exp, margin in flips:
        print(f"  K3 flip {what}: query {r} position {pos}: kernel id "
              f"{got}, plain id {exp}, plain margin {margin:.3g}")
    if exact and (flips or err):
        fail(f"K3 {what}: {len(flips)} ids / values differ from the plain "
             "version on exact scores")
    bad = [f for f in flips if not f[-1] < TOPK_TOL]
    if bad or not err <= TOPK_TOL:
        fail(f"K3 {what}: max |err| {err:.3g}, {len(bad)} flips outside "
             f"margin {TOPK_TOL}")
    return err, len(flips)


def topk_case(torch, topk_ops, what, q, c, k, exact=False):
    """K3 on (q, c) against its plain version on the same inputs, and
    against itself: a second launch must give the same bits."""
    vals, idx = topk_ops.similarity_topk(q, c, k)
    again = topk_ops.similarity_topk(q, c, k)
    rv, ri = topk_ops.similarity_topk(q, c, k + (not exact),
                                      impl="reference")
    torch.cuda.synchronize()
    if not (torch.equal(vals, again[0]) and torch.equal(idx, again[1])):
        fail(f"K3 {what}: two launches on the same inputs differ")
    err, flips = topk_gate(torch, what, vals, idx, rv, ri, exact=exact)
    print(f"K3 topk {what}: max|vals-plain|={err:.3g} (tol {TOPK_TOL}), "
          f"{flips} id flips within margin, repeat bitwise equal")
    return err


def check_topk(torch, topk_ops, dev):
    """K3 at the shapes of tests/test_kernels.py (fp32 and bf16 inputs), a
    k > N case, both selection paths, and sign vectors whose scores are
    exact: there every tie is decided by the tie rule alone."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for Q, N, D, k in ((13, 201, 48, 5), (32, 512, 64, 17),
                           (1, 1000, 32, 1), (64, 64, 128, 64),
                           (3, 4, 16, 7), (24, 5000, 64, 300)):
            q = torch.randn((Q, D), generator=gen, device=dev).to(dtype)
            c = torch.randn((N, D), generator=gen, device=dev).to(dtype)
            err = max(err, topk_case(torch, topk_ops,
                                     f"{name} Q={Q} N={N} D={D} k={k}",
                                     q, c, k))
    signs = (torch.randint(0, 2, (2000, 16), generator=gen, device=dev)
             * 2 - 1).float()
    signs[1000:1020] = signs[7]                    # exact duplicate rows
    q = torch.cat([signs[:8], (torch.randint(
        0, 2, (56, 16), generator=gen, device=dev) * 2 - 1).float()])
    for k in (1, 8, 32, 100, 128, 129, 2000):
        err = max(err, topk_case(torch, topk_ops,
                                 f"sign vectors Q=64 N=2000 D=16 k={k}",
                                 q, signs, k, exact=True))
    return err


def index_texts(n, seed):
    """``n`` distinct short catalog-like texts, from ``seed``."""
    import random
    rng = random.Random(seed)
    items = ["laptop", "headphones", "kettle", "bicycle", "novel", "camera",
             "jacket", "printer", "guitar", "lamp", "backpack", "monitor"]
    traits = ["quiet", "cheap", "sturdy", "broken on arrival", "light",
              "fast", "late", "well made", "overpriced", "excellent"]
    out = set()
    while len(out) < n:
        out.add(f"review {rng.randrange(10 ** 6)}: the {rng.choice(items)} "
                f"was {rng.choice(traits)}")
    return sorted(out)


def index_path(torch, eng, errs):
    """Drive the semantic index on the served engine at full width, hold
    every search to a plain-path manager sharing the store, and check K3's
    launch count.  Returns the kernels-line row of K3."""
    from repro_torch.inference.api import CortexClient
    from repro_torch.inference.pipeline import PipelineConfig
    from repro_torch.inference.scheduler import Scheduler
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.semindex import SemanticIndexManager, SemIndexConfig
    from repro_torch.semindex.index import _normalize
    # make_engine_client's three steps, over the engine already loaded;
    # EMBED goes to the served model, not the default embedder name
    sched = Scheduler()
    sched.register(eng)
    client = CortexClient(sched, default_model="proxy-8b",
                          proxy_model="proxy-8b", embed_model="proxy-8b",
                          pipeline=PipelineConfig())
    cfg = SemIndexConfig(dim=64)
    texts = index_texts(512, SEED + 3)
    queries = index_texts(576, SEED + 4)[-64:]
    queries = [f"looking for: {t}" for t in queries]
    mgr = SemanticIndexManager(cfg)
    col = "reviews.text"
    k_flat, k_cand = 8, 32

    topk_ops.LAUNCHES = 0
    flash_ops.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = mgr.ensure_index(client, col, texts)
    t_build = time.perf_counter() - t0
    qv = mgr.embed_texts(client, queries)
    corpus = mgr.embed_texts(client, texts)
    k2_embed = flash_ops.LAUNCHES
    k3_before = topk_ops.LAUNCHES
    t0 = time.perf_counter()
    flat = mgr.search(col, qv, k_flat)
    ivf = mgr.search(col, qv, k_flat, exact=False)
    cand = mgr.topk_candidates(qv, corpus, k_cand)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = topk_ops.LAUNCHES
    # the probe set, from the same kernel (reads done after the counts)
    _, probe = index._topk(index._tensor(_normalize(qv)), index._centroids,
                           cfg.nprobe)
    cells = {int(c) for c in set(probe.ravel().tolist())
             if len(index.cells[c])}
    expect = 1 + (1 + len(cells)) + 1
    print(f"index: {len(texts)} texts embedded by {eng.cfg.name} at full "
          f"width and indexed in {t_build:.2f} s (nlist {index.nlist}, "
          f"{sum(len(c) for c in index.cells)} vectors, cells of "
          f"{min(len(c) for c in index.cells)}-"
          f"{max(len(c) for c in index.cells)}); {len(queries)} queries; "
          f"flat k={k_flat}, IVF k={k_flat} nprobe {cfg.nprobe} over "
          f"{len(cells)} probed cells, topk_candidates k={k_cand} in "
          f"{t_search * 1e3:.1f} ms")
    print(f"index launches: K3 {launches} (before the searches "
          f"{k3_before}), expected {expect} (flat 1, IVF 1 probe + "
          f"{len(cells)} cells, candidates 1); K2 {k2_embed} over the "
          "EMBED passes")
    if launches != expect or k3_before != 0:
        fail("K3 launch count differs from the searches' calls")
    if k2_embed == 0 or k2_embed % eng.cfg.num_layers:
        fail(f"the index's EMBED passes launched K2 {k2_embed} times")
    if not (index.vectors.is_cuda and qv.shape == (64, cfg.dim)
            and bool(torch.isfinite(torch.from_numpy(qv)).all())):
        fail("the index corpus is not on the card or the queries are bad")

    # the plain path: a second manager on the same store, plain top-k
    calls = dict(client.calls_by_model)
    ref = SemanticIndexManager(SemIndexConfig(dim=64, impl="reference"),
                               store=mgr.store)
    ref_index = ref.ensure_index(client, col, texts)
    ref_qv = ref.embed_texts(client, queries)
    if (ref.snapshot()["embed_llm_calls"] != 0
            or client.calls_by_model != calls):
        fail("the plain-path manager dispatched EMBED: the store is cold")
    if not ((ref_qv == qv).all() and (ref_index.centroids
                                      == index.centroids).all()):
        fail("the two managers disagree on vectors or centroids")
    err = 0.0
    for what, got, want in (
            ("served flat search", flat, ref.search(col, qv, k_flat + 1)),
            ("served IVF search", ivf,
             ref.search(col, qv, k_flat + 1, exact=False)),
            ("served topk_candidates", cand,
             ref.topk_candidates(qv, corpus, k_cand + 1))):
        e, n_flips = topk_gate(torch, what, *got, *want)
        print(f"K3 {what}: max|vals-plain|={e:.3g} (tol {TOPK_TOL}), "
              f"{n_flips} id flips within margin; top-1 cosine mean "
              f"{float(got[0][:, 0].mean()):.6f}, k-th "
              f"{float(got[0][:, -1].mean()):.6f}")
        err = max(err, e)
    print(f"index snapshot: {mgr.snapshot()}")
    print(f"plain-path snapshot: {ref.snapshot()}")
    print(f"client: {client.snapshot()}")

    # time K3 at the served flat search's shape
    q = topk_ops.l2_normalize(index._tensor(_normalize(qv)))
    c = topk_ops.l2_normalize(index.vectors)
    t = time_topk(torch, topk_ops, "served flat search", q, c, k_flat)
    errs["similarity_topk"] = max(errs["similarity_topk"], err,
                                  t.pop("max_abs_err"))
    return kernel_row("similarity_topk", launches, errs["similarity_topk"],
                      t)


def topk_bounds(Q, N, D, k):
    """K3's bound: q and c read once, vals and idx written once, against
    the operations of the instruction it runs, three TF32 products of
    2*Q*N*D operations each at the TF32 rate (3xTF32).  Beside it, as in
    earlier runs, the same bytes against 2*Q*N*D fp32 FMA operations at
    the fp32 rate."""
    nbytes = 4.0 * (Q * D + N * D) + 8.0 * Q * k  # q, c in; vals, idx out
    b_ms, b_by = bound(nbytes, 3 * 2.0 * Q * N * D, "tf32")
    f_ms, f_by = bound(nbytes, 2.0 * Q * N * D, "float32")
    return {"bound_ms": b_ms, "bound_by": b_by, "fp32_fma_bound_ms": f_ms,
            "fp32_fma_bound_by": f_by}


def time_topk(torch, topk_ops, what, q, c, k, iters=20, plain_rows=None):
    """K3 on unit fp32 rows beside its plain version, its bound and
    ``torch.topk(q @ c.T, k)``.  ``plain_rows`` cuts the plain version
    (and its comparison) to the first queries, where its [Q, N] sort
    would not fit."""
    Q, D = q.shape
    N = c.shape[0]
    qp = q[:plain_rows] if plain_rows else q
    vals, idx = topk_ops.similarity_topk_cuda(q, c, k)
    rv, ri = topk_ops.similarity_topk(qp, c, k + 1, impl="reference")
    torch.cuda.synchronize()
    err, flips = topk_gate(torch, what, vals[:qp.shape[0]],
                           idx[:qp.shape[0]], rv, ri)
    ms = cuda_time_ms(lambda: topk_ops.similarity_topk_cuda(q, c, k), iters)
    plain_ms = cuda_time_ms(lambda: topk_ops.similarity_topk(
        qp, c, k, impl="reference"), max(iters // 4, 3), warmup=1)
    lib_ms = cuda_time_ms(lambda: torch.topk(q @ c.T, k), iters)
    dev_ms = device_ms(lambda: topk_ops.similarity_topk_cuda(q, c, k),
                       min(iters, 20))
    b = topk_bounds(Q, N, D, k)
    cut = f" (plain on the first {qp.shape[0]} queries)" if plain_rows else ""
    print(f"time K3 {what} Q={Q} N={N} D={D} k={k} fp32: kernel {ms:.4f} "
          f"ms (device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms{cut}, "
          "torch.topk(q@c.T) "
          f"{lib_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']}"
          f", 3xTF32), fp32 FMA bound {b['fp32_fma_bound_ms']:.5f} ms "
          f"({b['fp32_fma_bound_by']}); max|err| {err:.3g}, {flips} flips "
          "within margin")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **b, "max_abs_err": err}


def topk_full_shapes(torch, topk_ops, dev):
    """K3 at two production shapes over a one-million-row corpus: join
    blocking at the default dim (A) and ORDER BY ... LIMIT 100 at a wide
    embedder's width (B)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for what, Q, N, D, k, rows in (("full A", 1024, 1 << 20, 64, 8, 64),
                                   ("full B", 16, 1 << 20, 1024, 100, None)):
        q = topk_ops.l2_normalize(torch.randn((Q, D), generator=gen,
                                              device=dev))
        c = topk_ops.l2_normalize(torch.randn((N, D), generator=gen,
                                              device=dev))
        time_topk(torch, topk_ops, what, q, c, k, iters=10, plain_rows=rows)
        del q, c
        torch.cuda.empty_cache()


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on the card", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.inference.engine import TorchInferenceEngine

    # 1-2. build, then hold each kernel against its plain version
    build_kernels(dec_ops, flash_ops, topk_ops, rglru_ops, rwkv_ops)
    errs = check_kernels(torch, dec_ops, flash_ops, dev)
    errs["similarity_topk"] = check_topk(torch, topk_ops, dev)
    check_scans(torch, rglru_ops, rwkv_ops, dev, errs)

    # 3. serve one mixed batch with proxy-8b at full width
    t0 = time.perf_counter()
    eng = TorchInferenceEngine("proxy-8b", smoke=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"engine: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
          f"{cfg.head_dim} vocab {cfg.vocab_size} {cfg.dtype}, "
          f"{n_params / 1e9:.2f} B params, built in "
          f"{time.perf_counter() - t0:.1f} s; depth not cut "
          f"({cfg.num_layers} of {N_LAYERS} layers)")
    if cfg.num_layers != N_LAYERS or cfg.d_model != 4096:
        fail("proxy-8b is not at full width")
    rows = [r | {"path": "proxy-8b"} for r in serve_and_check(torch, eng,
                                                              errs)]
    # 7. the semantic index on the same engine, through K3
    rows.append(index_path(torch, eng, errs) | {"path": "semantic index"})
    long_shapes(torch, dec_ops, flash_ops, dev)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    topk_full_shapes(torch, topk_ops, dev)
    # 8-9. rwkv6-1.6b (K5), then recurrentgemma-9b (K4; K2, K1 at hd 256)
    rows += rwkv_path(torch, errs)
    rows += recurrentgemma_path(torch, errs)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_decode(torch, dec_ops, q, kc, vc, lengths, iters=200):
    import torch.nn.functional as F
    out = dec_ops.decode_attention_cuda(q, kc, vc, lengths)
    ref = dec_ops.flash_decode(q, kc, vc, lengths, impl="reference")
    err = max_err(out, ref)
    B, _, H, hd = q.shape
    Smax = kc.shape[1]
    mask = (torch.arange(Smax, device=q.device)[None]
            < lengths[:, None])[:, None, None]            # [B,1,1,Smax]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    ms = cuda_time_ms(lambda: dec_ops.decode_attention_cuda(
        q, kc, vc, lengths), iters)
    plain_ms = cuda_time_ms(lambda: dec_ops.flash_decode(
        q, kc, vc, lengths, impl="reference"), max(iters // 10, 5))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    dev_ms = device_ms(lambda: dec_ops.decode_attention_cuda(
        q, kc, vc, lengths))
    b_ms, b_by = decode_bound(q, kc, lengths)
    print(f"time K1 decode B={B} H={H} KV={kc.shape[2]} hd={hd} Smax={Smax} "
          f"lengths={lengths.tolist()} {str(q.dtype).split('.')[-1]}: "
          f"kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "max_abs_err": err}


def time_flash(torch, flash_ops, q, k, v, causal=True, window=0, iters=50):
    import torch.nn.functional as F
    out = flash_ops.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    ref = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl="reference")
    err = max_err(out, ref)
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kp = torch.arange(Skv, device=q.device)[None]
    mask = (kp <= qp) if causal else torch.ones_like(kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = cuda_time_ms(lambda: flash_ops.flash_attention_cuda(
        q, k, v, causal=causal, window=window), iters)
    plain_ms = cuda_time_ms(lambda: flash_ops.flash_attention(
        q, k, v, causal=causal, window=window, impl="reference"),
        max(iters // 5, 5))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    dev_ms = device_ms(lambda: flash_ops.flash_attention_cuda(
        q, k, v, causal=causal, window=window))
    b_ms, b_by = flash_bound(q, k, causal, window)
    print(f"time K2 flash B={B} Sq={Sq} Skv={Skv} H={H} KV={k.shape[2]} "
          f"hd={hd} causal={causal} window={window} "
          f"{str(q.dtype).split('.')[-1]}: kernel {ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms ({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "max_abs_err": err}


def long_shapes(torch, dec_ops, flash_ops, dev):
    """The model's attention at a full 512-token cache (decode) and a
    384-token prefill of 8 rows, for comparison across PRs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, H, KV, hd = 8, 32, 8, 128

    def r(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    time_decode(torch, dec_ops, r(B, 1, H, hd), r(B, 512, KV, hd),
                r(B, 512, KV, hd),
                torch.full((B,), 512, dtype=torch.int32, device=dev))
    time_flash(torch, flash_ops, r(B, 384, H, hd), r(B, 384, KV, hd),
               r(B, 384, KV, hd), iters=20)


def profile_served(torch, eng, reqs):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.submit_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile: served batch wall {wall * 1e3:.1f} ms (profiler on), "
          f"device busy {busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
