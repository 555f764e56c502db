#!/usr/bin/env python3
"""Time two versions of a kernel on one card, in one process: the parent
commit's build and this tree's, at the shapes ``chip_smoke.py`` times.

    mkdir -p OLD && git archive <parent> src/repro_torch | tar -x -C OLD
    python3 tools/kernel_ab.py --old OLD [--kernels decode_attention ...]
                               [--grad-cell]

``--old`` is a directory holding the parent's ``src/repro_torch`` (keep it
out of git's view, in a directory ``.gitignore`` lists): its
``ops.py`` wrappers are loaded under another name over its own
``build.py``, which builds its own ``csrc/*.cu``, so the two versions
share inputs, card and clocks.  Each shape is timed in ROUNDS
(4) rounds of turns, old, new, new, old, and each version's time is the
mean of its turns; a served shape's launches are
bound by the host, so each of its turns times 200 calls (K1 at every
shape, K5 but at the full shape).  Every new result is first held to the plain version with
``chip_smoke.py``'s gates; the old one is only timed.  K4 (``ab_rglru``)
is timed forward and backward: the old backward is the plain recompute
that the parent's ``RglruScanFn`` ran, the new one K4 in reverse.
``--grad-cell`` then runs recurrentgemma-9b's gradient cell of
``chip_smoke.py`` (``GRAD_CELLS``) with the old and the new K4 swapped
into the model in turns: one backward, one train step, peak memory, the
wall time inside K4's backward, and one profiled step of each.  Needs a
CUDA card; imports nothing of JAX.  ``--out FILE`` also writes the rows
as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

# (what, Q, N, D, k): the index phase's served searches (random unit rows
# at their shapes), then the full shapes
TOPK_SHAPES = [("served flat search", 64, 512, 64, 8),
               ("served topk_candidates", 64, 512, 64, 32),
               ("full A", 1024, 1 << 20, 64, 8),
               ("full B", 16, 1 << 20, 1024, 100)]
# (what, B, S, H, KV, hd, window): the served passes with the most work
# (proxy-8b's CLASSIFY / EMBED pass, recurrentgemma's) and the full shapes
FLASH_SHAPES = [("proxy-8b served", 6, 128, 32, 8, 128, 0),
                ("hd 128 full", 8, 384, 32, 8, 128, 0),
                ("recurrentgemma served", 8, 128, 16, 1, 256, 2048),
                ("hd 256 full", 8, 384, 16, 1, 256, 2048)]
# (what, B, H, KV, hd, Smax, lengths): the served decode step with the most
# keys (chip_smoke.py's batch: proxy-8b's gathered cache of 32-token
# blocks, recurrentgemma's 2,048-slot ring), then the full caches
DECODE_SHAPES = [("proxy-8b served", 8, 32, 8, 128, 128,
                  (108, 78, 79, 64, 1, 1, 1, 1)),
                 ("hd 128 full", 8, 32, 8, 128, 512, (512,) * 8),
                 ("recurrentgemma served", 4, 16, 1, 256, 2048,
                  (109, 78, 79, 64)),
                 ("hd 256 full", 8, 16, 1, 256, 2048, (2048,) * 8)]
# (what, B, S, H, hd): rwkv6-1.6b's largest served pass, the full shape and
# a served decode step (the 4 COMPLETE rows)
RWKV_SHAPES = [("served", 8, 128, 32, 64), ("full", 8, 384, 32, 64),
               ("decode step", 4, 1, 32, 64)]
# (what, B, S, W), fp32 as recurrentgemma-9b makes a and b: its largest
# served pass, the full shape and a train microbatch (GRAD_CELLS)
RGLRU_SHAPES = [("served", 8, 128, 4096), ("full", 8, 384, 4096),
                ("train", 1, 2560, 4096)]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_old(old_root: Path, name: str):
    """The parent's ``kernels/<name>/ops.py`` with the parent's
    ``kernels/build.py`` under it, so that it binds its own source with
    its own helpers (its library builds into the parent tree's
    ``_build/``)."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels import build as new_build
    pkg = old_root / "src" / "repro_torch" / "kernels"
    kernels.build = _module(pkg / "build.py", "old_kernels_build")
    try:
        return _module(pkg / name / "ops.py", f"old_{name}_ops")
    finally:
        kernels.build = new_build


def fmt(times):
    return ", ".join(f"{x:.4f}" for x in times)


ROUNDS = 4


def turns(old_fn, new_fn, iters, old_iters=None):
    """ROUNDS rounds of old, new, new, old: the mean of each version's
    turns, and every turn's time in order.  ``old_iters``: the old
    version's calls a turn where it is far slower (one warm-up call)."""
    def timed(f):
        if f is old_fn and old_iters is not None:
            return smoke.cuda_time_ms(f, old_iters, warmup=1)
        return smoke.cuda_time_ms(f, iters)
    t = [timed(f)
         for _ in range(ROUNDS) for f in (old_fn, new_fn, new_fn, old_fn)]
    old = [x for i, x in enumerate(t) if i % 4 in (0, 3)]
    new = [x for i, x in enumerate(t) if i % 4 in (1, 2)]
    return sum(old) / len(old), sum(new) / len(new), t


def ab_topk(torch, old, new, dev):
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 5)
    rows = []
    for what, Q, N, D, k in TOPK_SHAPES:
        q, c = (new.l2_normalize(torch.randn(s, generator=gen, device=dev))
                for s in ((Q, D), (N, D)))
        vals, idx = new.similarity_topk_cuda(q, c, k)
        qp = q[:64]                       # the plain sort fits 64 queries
        rv, ri = new.similarity_topk(qp, c, k + 1, impl="reference")
        torch.cuda.synchronize()
        err, flips = smoke.topk_gate(torch, what, vals[:64], idx[:64], rv,
                                     ri)
        iters = 10 if N > 4096 else 200
        old_ms, new_ms, raw = turns(
            lambda: old.similarity_topk_cuda(q, c, k),
            lambda: new.similarity_topk_cuda(q, c, k), iters)
        lib_ms = smoke.cuda_time_ms(lambda: torch.topk(q @ c.T, k), iters)
        dev_old = smoke.device_ms(lambda: old.similarity_topk_cuda(q, c, k))
        dev_new = smoke.device_ms(lambda: new.similarity_topk_cuda(q, c, k))
        b = smoke.topk_bounds(Q, N, D, k)
        print(f"ab K3 {what} Q={Q} N={N} D={D} k={k}: old {old_ms:.4f} ms, "
              f"new {new_ms:.4f} ms (turns {fmt(raw)}), torch.topk(q@c.T) "
              f"{lib_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}, 3xTF32), fp32 FMA bound "
              f"{b['fp32_fma_bound_ms']:.5f} ms; max|err| {err:.3g}, "
              f"{flips} flips within margin; device time old "
              f"{smoke.fmt_ms(dev_old)}, new {smoke.fmt_ms(dev_new)}")
        rows.append({"kernel": "similarity_topk", "shape": what, "Q": Q,
                     "N": N, "D": D, "k": k, "old_ms": old_ms,
                     "new_ms": new_ms, "turns_ms": raw, "library_ms": lib_ms,
                     "old_device_ms": dev_old, "new_device_ms": dev_new,
                     **b, "max_abs_err": err})
        del q, c
        torch.cuda.empty_cache()
    return rows


def ab_flash(torch, old, new, dev):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 6)
    rows = []
    for what, B, S, H, KV, hd, window in FLASH_SHAPES:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16) for s in ((B, S, H, hd), (B, S, KV, hd),
                                      (B, S, KV, hd)))
        out = new.flash_attention_cuda(q, k, v, window=window)
        ref = new.flash_attention(q, k, v, window=window, impl="reference")
        torch.cuda.synchronize()
        err = smoke.max_err(out, ref)
        if not err <= smoke.TOL["bfloat16"]:
            smoke.fail(f"K2 {what}: max|err| {err} against plain")
        old_ms, new_ms, raw = turns(
            lambda: old.flash_attention_cuda(q, k, v, window=window),
            lambda: new.flash_attention_cuda(q, k, v, window=window),
            200 if "served" in what else 50)
        pos = torch.arange(S, device=dev)
        mask = pos[None] <= pos[:, None]
        if window:
            mask &= pos[None] > pos[:, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = smoke.cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 50)
        b_ms, b_by = smoke.flash_bound(q, k, True, window)
        dev_old = smoke.device_ms(lambda: old.flash_attention_cuda(
            q, k, v, window=window))
        dev_new = smoke.device_ms(lambda: new.flash_attention_cuda(
            q, k, v, window=window))
        print(f"ab K2 {what} B={B} S={S} H={H} KV={KV} hd={hd} "
              f"window={window}: old {old_ms:.4f} ms, new {new_ms:.4f} ms "
              f"(turns {fmt(raw)}), sdpa "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); max|err| "
              f"{err:.3g}; device time old {smoke.fmt_ms(dev_old)}, new "
              f"{smoke.fmt_ms(dev_new)}")
        rows.append({"kernel": "flash_attention", "shape": what, "B": B,
                     "S": S, "H": H, "KV": KV, "hd": hd, "window": window,
                     "old_ms": old_ms, "new_ms": new_ms, "turns_ms": raw,
                     "old_device_ms": dev_old, "new_device_ms": dev_new,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": err})
    return rows


def ab_decode(torch, old, new, dev):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 7)
    rows = []
    for what, B, H, KV, hd, Smax, lens in DECODE_SHAPES:
        q, kc, vc = (torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16) for s in ((B, 1, H, hd), (B, Smax, KV, hd),
                                      (B, Smax, KV, hd)))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = new.decode_attention_cuda(q, kc, vc, lengths)
        ref = new.flash_decode(q, kc, vc, lengths, impl="reference")
        torch.cuda.synchronize()
        err = smoke.max_err(out, ref)
        if not err <= smoke.TOL["bfloat16"]:
            smoke.fail(f"K1 {what}: max|err| {err} against plain")
        old_ms, new_ms, raw = turns(
            lambda: old.decode_attention_cuda(q, kc, vc, lengths),
            lambda: new.decode_attention_cuda(q, kc, vc, lengths), 200)
        mask = (torch.arange(Smax, device=dev)[None]
                < lengths[:, None])[:, None, None]
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        lib_ms = smoke.cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 200)
        b_ms, b_by = smoke.decode_bound(q, kc, lengths)
        dev_old = smoke.device_ms(lambda: old.decode_attention_cuda(
            q, kc, vc, lengths))
        dev_new = smoke.device_ms(lambda: new.decode_attention_cuda(
            q, kc, vc, lengths))
        print(f"ab K1 {what} B={B} H={H} KV={KV} hd={hd} Smax={Smax}: old "
              f"{old_ms:.4f} ms, new {new_ms:.4f} ms (turns {fmt(raw)}), "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); max|err| "
              f"{err:.3g}; device time old {smoke.fmt_ms(dev_old)}, new "
              f"{smoke.fmt_ms(dev_new)}")
        rows.append({"kernel": "decode_attention", "shape": what, "B": B,
                     "H": H, "KV": KV, "hd": hd, "Smax": Smax,
                     "lengths": list(lens), "old_ms": old_ms,
                     "new_ms": new_ms, "turns_ms": raw,
                     "old_device_ms": dev_old, "new_device_ms": dev_new,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": err})
    return rows


def ab_rwkv(torch, old, new, dev):
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 8)
    rows = []
    for what, B, S, H, hd in RWKV_SHAPES:
        r, k, v = (torch.randn((B, S, H, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        w = smoke.decays(torch, gen, (B, S, H, hd), dev)
        u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
        s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev)
        o, sT = new.rwkv6_scan_cuda(r, k, v, w, u, s0)
        ref_o, ref_sT = new.rwkv6_scan(r, k, v, w, u, s0, impl="reference")
        torch.cuda.synchronize()
        err = max(smoke.rel_err(o, ref_o), smoke.rel_err(sT, ref_sT))
        if not err <= smoke.TOL["float32"]:
            smoke.fail(f"K5 {what}: relative error {err} against plain")
        old_ms, new_ms, raw = turns(
            lambda: old.rwkv6_scan_cuda(r, k, v, w, u, s0),
            lambda: new.rwkv6_scan_cuda(r, k, v, w, u, s0),
            50 if what == "full" else 200)
        b_ms, b_by = smoke.rwkv_bound(r)
        dev_old = smoke.device_ms(lambda: old.rwkv6_scan_cuda(
            r, k, v, w, u, s0))
        dev_new = smoke.device_ms(lambda: new.rwkv6_scan_cuda(
            r, k, v, w, u, s0))
        print(f"ab K5 {what} B={B} S={S} H={H} hd={hd}: old {old_ms:.4f} "
              f"ms, new {new_ms:.4f} ms (turns {fmt(raw)}), library none, "
              f"bound {b_ms:.5f} ms ({b_by}); rel. max|err| {err:.3g}; "
              f"device time old {smoke.fmt_ms(dev_old)}, new "
              f"{smoke.fmt_ms(dev_new)}")
        rows.append({"kernel": "rwkv6_scan", "shape": what, "B": B, "S": S,
                     "H": H, "hd": hd, "old_ms": old_ms, "new_ms": new_ms,
                     "turns_ms": raw, "old_device_ms": dev_old,
                     "new_device_ms": dev_new, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "rel_err": err})
    return rows


def ab_rglru(torch, old, new, dev):
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 9)
    needs = smoke.RGLRU_NEEDS
    rows = []
    for what, B, S, W in RGLRU_SHAPES:
        a = smoke.decays(torch, gen, (B, S, W), dev)
        b, d_hs = (torch.randn((B, S, W), generator=gen, device=dev)
                   for _ in range(2))
        h0 = torch.zeros((B, W), device=dev)
        d_hT = torch.randn((B, W), generator=gen, device=dev)
        hs, hT = new.rglru_scan_cuda(a, b, h0)
        ref_hs, ref_hT = new.rglru_scan(a, b, h0, impl="reference")
        got = new.rglru_scan_bwd_cuda(a, hs, h0, d_hs, d_hT, needs)
        want = rglru_scan_bwd_ref(a, ref_hs, h0, d_hs, d_hT)
        torch.cuda.synchronize()
        if not (torch.equal(hs, ref_hs) and torch.equal(hT, ref_hT)
                and all(torch.equal(g, w)
                        for g, w, n in zip(got, want, needs) if n)):
            smoke.fail(f"K4 {what}: differs from its plain version")
        del got, want, ref_hs
        iters = 200 if what == "served" else 50
        old_ms, new_ms, raw = turns(
            lambda: old.rglru_scan_cuda(a, b, h0),
            lambda: new.rglru_scan_cuda(a, b, h0), iters)
        dev_old = smoke.device_ms(lambda: old.rglru_scan_cuda(a, b, h0))
        dev_new = smoke.device_ms(lambda: new.rglru_scan_cuda(a, b, h0))

        def recompute():          # the parent's RglruScanFn.backward
            return old.recompute_grads(old.rglru_scan_ref, (a, b, h0), needs,
                                       (d_hs, d_hT))

        def reverse():
            return new.rglru_scan_bwd_cuda(a, hs, h0, d_hs, d_hT, needs)

        rec_ms, rev_ms, raw_bwd = turns(recompute, reverse, iters,
                                        old_iters=1)
        dev_rev = smoke.device_ms(reverse)
        (f_ms, f_by), (b_ms, b_by) = smoke.rglru_bounds(a)
        print(f"ab K4 {what} B={B} S={S} W={W} fp32: old {old_ms:.4f} ms, "
              f"new {new_ms:.4f} ms (turns {fmt(raw)}), library none, bound "
              f"{f_ms:.5f} ms ({f_by}); device time old "
              f"{smoke.fmt_ms(dev_old)}, new {smoke.fmt_ms(dev_new)}; "
              f"backward (da, db): old plain recompute {rec_ms:.4f} ms, new "
              f"reverse {rev_ms:.4f} ms (turns {fmt(raw_bwd)}), device "
              f"{smoke.fmt_ms(dev_rev)}, bound {b_ms:.5f} ms ({b_by}); "
              "bitwise equal to the plain version both ways")
        rows.append({"kernel": "rglru_scan", "shape": what, "B": B, "S": S,
                     "W": W, "old_ms": old_ms, "new_ms": new_ms,
                     "turns_ms": raw, "old_device_ms": dev_old,
                     "new_device_ms": dev_new, "library_ms": None,
                     "bound_ms": f_ms, "bound_by": f_by,
                     "old_backward_ms": rec_ms, "new_backward_ms": rev_ms,
                     "backward_turns_ms": raw_bwd,
                     "new_backward_device_ms": dev_rev,
                     "backward_bound_ms": b_ms, "backward_bound_by": b_by,
                     "max_abs_err": 0.0})
        del a, b, d_hs, hs
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def timed_backward(torch, fn_cls):
    """Add the wall seconds spent in ``fn_cls.backward`` (the card
    synchronised before and after each call) to the yielded list's
    first entry."""
    spent = [0.0]
    orig = fn_cls.__dict__["backward"]

    def backward(ctx, *grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig.__func__(ctx, *grads)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    fn_cls.backward = staticmethod(backward)
    try:
        yield spent
    finally:
        fn_cls.backward = orig


def ab_grad_cell(torch, old, new, dev):
    """recurrentgemma-9b's gradient cell with the parent's K4 module and
    this tree's swapped into the model (``blocks.rglru_ops``) in turns:
    one backward (``step.grads``) and one AdamW step each turn, peak
    memory; then per version one backward with K4's backward timed apart
    and one profiled step (idle share; the reverse kernel's share)."""
    from repro_torch.configs import base as cfgs
    from repro_torch.models import blocks, model_zoo
    from repro_torch.train import optim, train_step
    layers, B, S, dtype = smoke.GRAD_CELLS["recurrentgemma-9b"]
    cfg = dataclasses.replace(cfgs.get_config("recurrentgemma-9b"),
                              dtype=dtype, num_layers=layers)
    model = model_zoo.build(cfg)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(smoke.SEED))
    batch = smoke.train_batch(torch, cfg, B, S, dev)
    step = train_step.make_train_step(
        model, optim.AdamWConfig(lr=smoke.TRAIN_LR, warmup_steps=1))
    state = {"params": params, "opt_state": optim.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    mods = {"old": old, "new": new}
    res = {v: {"grads_s": [], "step_s": [], "peak_gb": []} for v in mods}
    keep = blocks.rglru_ops

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    try:
        blocks.rglru_ops = new
        step(state, batch)                  # warm: allocator, cuBLAS
        for v in ("old", "new", "new", "old"):
            blocks.rglru_ops = mods[v]
            torch.cuda.reset_peak_memory_stats()
            res[v]["grads_s"].append(timed(lambda: step.grads(params, batch)))
            res[v]["step_s"].append(timed(lambda: step(state, batch)))
            res[v]["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        for v, mod in mods.items():
            blocks.rglru_ops = mod
            with timed_backward(torch, mod.RglruScanFn) as spent:
                res[v]["grads_timed_s"] = timed(
                    lambda: step.grads(params, batch))
            res[v]["k4_backward_s"] = spent[0]
            res[v]["idle"], res[v]["reverse_share"] = smoke.profile_step(
                torch, f"recurrentgemma-9b train step, {v} K4",
                lambda: step(state, batch), share_of="rglru_bwd_kernel")
    finally:
        blocks.rglru_ops = keep
    for v, r in res.items():
        print(f"ab grad cell recurrentgemma-9b {layers} layers B={B} S={S} "
              f"{dtype}, {v} K4: one backward {fmt(r['grads_s'])} s, step "
              f"{fmt(r['step_s'])} s, peak {fmt(r['peak_gb'])} GB; K4's "
              f"backward {r['k4_backward_s']:.4f} s of a timed backward of "
              f"{r['grads_timed_s']:.4f} s "
              f"({r['k4_backward_s'] / r['grads_timed_s']:.4f}); idle share "
              f"{r['idle']}, reverse kernel's share of the busy time "
              f"{r['reverse_share']}")
    del state, params
    torch.cuda.empty_cache()
    return [{"kernel": "rglru_scan", "shape": "grad cell recurrentgemma-9b",
             "layers": layers, "B": B, "S": S, "dtype": dtype, **{
                 f"{v}_{k}": x for v, r in res.items() for k, x in r.items()}}]


AB = {"similarity_topk": ab_topk, "flash_attention": ab_flash,
      "decode_attention": ab_decode, "rwkv6_scan": ab_rwkv,
      "rglru_scan": ab_rglru}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory holding the parent's src/repro_torch")
    ap.add_argument("--out", type=Path, help="write the rows here (JSON)")
    ap.add_argument("--kernels", nargs="+", default=list(AB), choices=AB)
    ap.add_argument("--grad-cell", action="store_true",
                    help="also run recurrentgemma-9b's gradient cell with "
                    "the old and the new K4 in turns")
    args = ap.parse_args()
    if args.grad_cell and "rglru_scan" not in args.kernels:
        args.kernels.append("rglru_scan")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    card = smoke.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    new = {n: importlib.import_module(f"repro_torch.kernels.{n}.ops")
           for n in args.kernels}
    old = {n: load_old(args.old, n) for n in args.kernels}
    libs = [m.LIB for n in args.kernels for m in (old[n], new[n])]
    smoke.build_kernels(*[types.SimpleNamespace(LIB=lib) for lib in libs])
    rows = []
    for n in args.kernels:
        rows += AB[n](torch, old[n], new[n], dev)
    if args.grad_cell:
        rows += ab_grad_cell(torch, old["rglru_scan"], new["rglru_scan"],
                             dev)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
