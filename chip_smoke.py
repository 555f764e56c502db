#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, serves one mixed
batch (SCORE, COMPLETE, CLASSIFY, EMBED) with proxy-8b at full width
(32 layers, d_model 4096, vocab 128256, bf16, random weights from a seed),
checks that the served path launched each kernel the expected number of
times and that its results are well formed, holds what goes through the
kernels (every decode step's logits, CLASSIFY's label logprobs, EMBED's
vectors) to the same computed through the plain attention, then times
each kernel beside its plain version, its bound and one PyTorch library
call.  The last line is a JSON
object with ``"ok": true``; any failed check exits non-zero without it.
It needs no network and imports nothing of JAX.
"""
from __future__ import annotations

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
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
TOL = {"bfloat16": 5e-2, "float32": 2e-4}  # the tolerances of the CPU tests
# kernel-served vs plain-served limits at full width (bf16, 32 layers),
# a few times the readings on the H100 (PERF.md, section 6)
SERVE_TOL = {"decode_logits_rel": 0.05, "classify_logprob": 0.05,
             "embed_cosine": 0.9995}
SEED = 0
N_LAYERS = 32

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


def build_kernels(dec_ops, flash_ops):
    t0 = time.perf_counter()
    libs = (dec_ops.LIB, flash_ops.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:     # one nvcc per source
        list(pool.map(lambda lib: lib.load(), libs))
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{dec_ops.LIB.source.name} + {flash_ops.LIB.source.name} "
          "(nvcc, sm_90a, in parallel)")
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
    return errs


def requests():
    from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED,
                                               SCORE, Request)
    reqs = [Request(p, "proxy-8b", SCORE) for p in PROMPTS_SCORE]
    reqs += [Request(p, "proxy-8b", COMPLETE, max_tokens=16)
             for p in PROMPTS_COMPLETE]
    reqs += [Request(p, "proxy-8b", CLASSIFY, labels=lbls)
             for p, lbls in PROMPTS_CLASSIFY]
    reqs += [Request(p, "proxy-8b", EMBED, metadata={"embed_dim": 256})
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
    print(f"kernel vs plain, K1: decode-step logits over {len(probe)} steps "
          f"max rel. L2 err {logits_rel:.3g} (tol "
          f"{SERVE_TOL['decode_logits_rel']}), max |err| {logits_abs:.3g}, "
          f"same top-1 token {top1[0]}/{top1[1]} rows")
    print(f"kernel vs plain, K2: CLASSIFY label logprobs {len(lps)} pairs "
          f"max |err| {d_lp:.3g} nats (tol {SERVE_TOL['classify_logprob']}), "
          f"labels same {same_label}/{n_cls}; EMBED min cosine {cos:.6f} "
          f"(tol {SERVE_TOL['embed_cosine']})")
    print(f"COMPLETE leading tokens equal {agree} (not gated: greedy argmax "
          "over near-flat random logits can flip on bf16 rounding)")
    if len(lps) != len(ref_lps) or not lps or not probe:
        fail("the served path ran no CLASSIFY pass or no decode step")
    if not (logits_rel <= SERVE_TOL["decode_logits_rel"]
            and d_lp <= SERVE_TOL["classify_logprob"]
            and cos >= SERVE_TOL["embed_cosine"]):
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
    for name, (_, args, kw), src, tpu in (
            ("decode_attention", k1_served,
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:74"),
            ("flash_attention", k2_served,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:86")):
        t = (time_decode(torch, dec_ops, *args) if name == "decode_attention"
             else time_flash(torch, flash_ops, *args, **kw))
        err = t.pop("max_abs_err")
        tol = TOL[str(args[0].dtype).split(".")[-1]]
        if not err <= tol:
            fail(f"{name} disagrees with its plain version on the served "
                 f"path's inputs: {err} > {tol}")
        errs[name] = max(errs[name], err)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": errs[name], **t})
    return rows


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
    from repro_torch.inference.engine import TorchInferenceEngine

    # 1-2. build, then hold each kernel against its plain version
    build_kernels(dec_ops, flash_ops)
    errs = check_kernels(torch, dec_ops, flash_ops, dev)

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
    rows = serve_and_check(torch, eng, errs)
    long_shapes(torch, dec_ops, flash_ops, dev)

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
    b_ms, b_by = decode_bound(q, kc, lengths)
    print(f"time K1 decode B={B} H={H} KV={kc.shape[2]} hd={hd} Smax={Smax} "
          f"lengths={lengths.tolist()} {str(q.dtype).split('.')[-1]}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms ({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err}


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
    b_ms, b_by = flash_bound(q, k, causal, window)
    print(f"time K2 flash B={B} Sq={Sq} Skv={Skv} H={H} KV={k.shape[2]} "
          f"hd={hd} causal={causal} window={window} "
          f"{str(q.dtype).split('.')[-1]}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err}


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
