"""The port's dry-run (``repro_torch.launch.dryrun``) held to the JAX
package's on the CPU, and the repairs it needed.

The port's dry-run starts fake worlds, so it runs in a process of its own
(``tests/_torch_dryrun_worker.py``); the JAX package's references run in
another, with 512 forced host devices (``tests/_jax_dryrun_ref.py``).

  * ``cells``, ``skipped_cells`` and ``all_configs`` are the JAX
    package's; the production meshes have its shapes and axis names at
    ``model=16`` and (32, 8) / (2, 32, 8) at ``model=8``; a world of
    another size is refused.
  * ``op_cost`` counts this rank's work on a mesh: a sharded matmul on
    four fake ranks counts a quarter of one rank's FLOPs (and bytes, where
    both operands are sharded), on meta and on CPU tensors, though
    DTensor's sharding propagation ran the op on fake tensors of the
    global shapes; a smoke proxy-8b prefill cell's per-device dot FLOPs
    on (1, 4) and (4, 1) meshes lie within ``DOT_TOL`` of the JAX
    package's per-partition HLO dots (``hlo_cost.analyze_hlo``).
  * wire bytes by mesh axis: each collective kind alone (a DTensor
    redistribution, and a c10d all-reduce on the model axis's group)
    counts the ring formula's bytes on its axis; proxy-8b's prefill
    cell on (2, 2) counts the bytes of its collectives worked out by
    hand; and every collective of a few cells is counted once: the
    counter's counts by kind equal torch's ``CommDebugMode``'s.
  * every arch x kind at smoke widths (head dim 64, which the kernels
    take) and a small shape runs through ``run_cell`` on meta over a fake
    (2, 2) mesh: its per-device ``argument_bytes`` equal JAX's
    ``memory_analysis().argument_size_in_bytes`` of the same cell lowered
    on four devices with ``keep_unused=True`` (jax.jit's default drops
    the arguments a step never reads: a parallel block's ln2, whisper's
    encoder in a decode step; the port's step holds them all the same);
    train cells: the shard sums of the cell's shardings, which equal
    ``memory_analysis`` on the compiled one; its
    ``model_flops`` JAX's, and its kernel launches those the card makes.
  * one full-width cell (proxy-8b ``decode_32k`` on 256 fake ranks) has
    the argument bytes of the analytic shard sums;
  * ``main([..., "--json", path])`` appends records that
    ``benchmarks.report_roofline`` renders;
  * the kernels' meta routes return the plain version's shapes and
    dtypes, report the kernel's work, leave ``LAUNCHES`` alone and reject
    what the CUDA wrappers reject; CPU tensors still take the plain
    version;
  * ``write_kv_sharded``'s write (``write_rows_owned``) is bit-equal to
    the boolean-mask write it replaced, calls no ``nonzero`` and runs on
    meta tensors.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DOT_TOL = 0.01
S, B = 32, 4
KINDS = ("train", "prefill", "decode")
CELLS = [(a, k, S, B) for a in cfgs.ARCH_IDS for k in KINDS]
DOTS = [("proxy-8b", "prefill", S, B, shape) for shape in ((1, 4), (4, 1))]
COMM = [("proxy-8b", k, S, B) for k in KINDS] + [
    ("qwen2-moe-a2.7b", "train", S, B), ("recurrentgemma-9b", "decode", S, B),
    ("whisper-base", "prefill", S, B)]
EXACT_TRAIN = "rwkv6-1.6b"
TIMEOUT = 420


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    job = {"cells": CELLS, "dots": DOTS, "comm": COMM,
           "exact_train": EXACT_TRAIN,
           "json": str(tmp / "records.json")}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, str(ROOT / "tests/_jax_dryrun_ref.py"),
             str(tmp / "job.pkl"), str(tmp / "jax.pkl")],
            env=dict(env, JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=512"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "torch": subprocess.Popen(
            [sys.executable, str(ROOT / "tests/_torch_dryrun_worker.py"),
             str(tmp / "job.pkl"), str(tmp / "torch.pkl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    outs = {}
    for name, p in procs.items():
        try:
            outs[name], _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, (name, outs[name][-4000:])
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "torch.pkl", "rb") as f:
        got = pickle.load(f)
    assert "error" not in got, got["error"]
    return got, ref, job, outs["torch"]


# ---------------------------------------------------------------------------
# configs and meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_cells_and_skips_match_jax(arch):
    assert [s.name for s in cfgs.cells(arch)] == \
        [s.name for s in jcfgs.cells(arch)]
    assert [(s.name, r) for s, r in cfgs.skipped_cells(arch)] == \
        [(s.name, r) for s, r in jcfgs.skipped_cells(arch)]


def test_all_configs_match_jax():
    mine, theirs = cfgs.all_configs(), jcfgs.all_configs()
    assert [dataclasses.asdict(c) for c in mine] == \
        [dataclasses.asdict(c) for c in theirs]


def test_production_meshes(run):
    got, ref, _, _ = run
    assert got["mesh"][(False, 16)] == ref["mesh"][False] == (
        (16, 16), ("data", "model"))
    assert got["mesh"][(True, 16)] == ref["mesh"][True] == (
        (2, 16, 16), ("pod", "data", "model"))
    assert got["mesh"][(False, 8)] == ((32, 8), ("data", "model"))
    assert got["mesh"][(True, 8)] == ((2, 32, 8), ("pod", "data", "model"))
    assert "256 ranks" in got["refused"]


# ---------------------------------------------------------------------------
# per-device counts on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_sharded_matmul_counts_a_quarter(run, dev):
    got = run[0]["matmul"]
    mm, bmm = got[(dev, "mm")], got[(dev, "bmm")]
    assert mm["one"][0] == 2 * 64 * 128 * 256
    assert mm["four"][0] == mm["one"][0] / 4          # 1,048,576
    assert bmm["four"] == (bmm["one"][0] / 4, bmm["one"][1] / 4)
    assert mm["collectives"] == bmm["collectives"] == 0
    # the sharding propagation ran the op on global fake tensors (the
    # process is fresh: nothing cached), and none of it was counted
    if dev == "meta":
        assert mm["fake_ops"] > 0 and bmm["fake_ops"] > 0


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)])
def test_per_device_dots_match_jax_partitions(run, shape):
    got, ref, _, _ = run
    key = ("proxy-8b", "prefill", shape)
    want = ref["dots"][key]
    mine = got["dots"][key]["dot"]
    assert want > 0
    assert abs(mine - want) <= DOT_TOL * want, (mine, want)


# wire bytes by mesh axis: each collective kind alone, a cell whose plan
# is known, and torch's own count of every cell's collectives
# ---------------------------------------------------------------------------

# torch's collective ops (CommDebugMode's names) by the kind they are
TORCH_KIND = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
              "all_gather_into_tensor": "all-gather",
              "allgather_": "all-gather", "_allgather_base_": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_": "reduce-scatter",
              "_reduce_scatter_base_": "reduce-scatter",
              "all_to_all_single": "all-to-all",
              "alltoall_base_": "all-to-all"}


def test_redistribution_wire_bytes_by_axis(run):
    """One redistribution of a 512-byte local shard over one axis of 2
    ranks, and one c10d all-reduce on the model axis's group (its
    ProcessGroup reaches the counter boxed): the ring formulas' bytes
    over a group of 2, charged to that axis alone."""
    got = run[0]["redistributions"]
    assert got["gather_data"] == {"all-gather@data": 0.5 * 1024}
    assert got["gather_model"] == {"all-gather@model": 0.5 * 1024}
    assert got["reduce_model"] == {"all-reduce@model": 2 * 0.5 * 512}
    assert got["scatter_data"] == {"reduce-scatter@data": 0.5 * 512}
    assert got["c10d_reduce_model"] == {"all-reduce@model": 2 * 0.5 * 512}


def test_prefill_wire_bytes_by_axis_are_analytic(run):
    """proxy-8b's prefill cell on (data 2, model 2), bf16, weights
    TP-sharded only, its collectives counted by hand:
      * model: the vocab-parallel embedding's sum and each layer's two
        row-parallel sums (wo, w_down) of a [B/2, S, D] shard;
      * data: each layer's K and V gathered whole for the cache write
        (``blocks.write_prefix``), and the fp32 logits [B, V] gathered
        over the batch (``steps._full``);
      * model: the logits' vocab halves gathered."""
    rec = run[0]["comm"][("proxy-8b", "prefill")]["record"]
    cfg = dryrun.smoke_config("proxy-8b")
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    kv = B * S * cfg.num_kv_heads * cfg.head_dim * 2
    want = {"all-reduce@model": (1 + 2 * L) * 2 * 0.5 * (B // 2) * S * D * 2,
            "all-gather@data": 2 * L * 0.5 * kv + 0.5 * B * V * 4,
            "all-gather@model": 0.5 * (B // 2) * V * 4}
    assert rec["detail"]["collective_by_path"] == want
    assert rec["collectives"] == {"all-reduce": 1 + 2 * L,
                                  "all-gather": 2 * L + 2}
    assert rec["collective_bytes_per_dev"] == sum(want.values())
    assert rec["detail"]["collective_by_axis"] == {
        "model": want["all-reduce@model"] + want["all-gather@model"],
        "data": want["all-gather@data"]}


@pytest.mark.parametrize("arch,kind", [(a, k) for a, k, _, _ in COMM])
def test_cell_collectives_are_torch_comm_counts(run, arch, kind):
    """The counter counts each collective once: its counts by kind equal
    those of torch's ``CommDebugMode`` over the same step (the
    functional collectives DTensor issues and the c10d ones the
    sequence-sharded decode calls), and its wire bytes by axis add up to
    its total, every group being an axis of the mesh."""
    got = run[0]["comm"][(arch, kind)]
    rec = got["record"]
    want = Counter()
    for name, n in got["torch"].items():
        want[TORCH_KIND[name]] += n
    assert rec["collectives"] == dict(want)
    assert sum(want.values()) > 0
    by_axis = rec["detail"]["collective_by_axis"]
    assert set(by_axis) <= {"data", "model"}
    assert sum(by_axis.values()) == pytest.approx(
        rec["collective_bytes_per_dev"])


# ---------------------------------------------------------------------------
# every arch x kind on a fake (2, 2) mesh
# ---------------------------------------------------------------------------


def _jcfg(arch):
    cfg = jcfgs.get_smoke_config(arch)
    c = dryrun.smoke_config(arch)
    return dataclasses.replace(cfg, head_dim=c.head_dim,
                               mrope_sections=c.mrope_sections)


def expected_launches(cfg, kind):
    """The launches a step of ``kind`` makes on the card: each attention
    layer's K2 (K1 in a decode step; whisper's cross-attention K2 in both),
    each recurrent layer's K4 / K5 (no K4 in a decode step: one step of
    the recurrence is plain), a train step's period layers twice (their
    activations are recomputed) and K4's reverse once a layer."""
    out = Counter()
    if cfg.is_encoder_decoder:
        L, E = cfg.num_layers, cfg.encoder_layers
        if kind == "decode":
            out.update(decode_attention=L, flash_attention=L)
        else:
            out.update(flash_attention=E + 2 * L * (2 if kind == "train"
                                                    else 1))
        return dict(out)
    body = cfg.num_periods * len(cfg.period)
    for layer, blk in enumerate(cfg.block_pattern):
        c = 2 if kind == "train" and layer < body else 1
        if blk in (cfgs.ATTN, cfgs.LOCAL_ATTN):
            out["decode_attention" if kind == "decode"
                else "flash_attention"] += c
        elif blk == cfgs.RGLRU and kind != "decode":
            out["rglru_scan"] += c
            if kind == "train":
                out["rglru_scan_bwd"] += 1
        elif blk == cfgs.RWKV:
            out["rwkv6_scan"] += c
    return dict(out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_cell_on_meta_matches_jax(run, arch, kind):
    got, ref, _, _ = run
    rec = got["cells"][(arch, kind)]
    assert rec["ok"] and rec["mesh"] == "2x2" and rec["chips"] == 4
    mem = rec["memory_per_device"]
    assert mem["argument_bytes"] == ref["args"][(arch, kind)]
    assert mem["temp_bytes"] > 0 and mem["fits"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["model_flops"] == jzoo.model_flops(
        _jcfg(arch), jcfgs.ShapeSpec("t", S, B, kind))
    cfg = dryrun.smoke_config(arch)
    assert rec["detail"]["kernel_launches"] == expected_launches(cfg, kind)
    assert rec["hlo_flops_per_dev"] > 0 and 0 < rec["mfu_bound"] <= 1


def test_train_shard_sums_are_memory_analysis(run):
    _, ref, _, _ = run
    assert ref["train_shard_sum"] == ref["args"][(EXACT_TRAIN, "train")]


def test_full_width_cell_argument_bytes_are_the_shard_sums(run):
    """proxy-8b decode_32k on (data 32, model 8): B=128 divides the data
    axes, so the weights are TP-only: q / o projections, the MLP, the
    embedding and the head split 8 ways over ``model``, the GQA k / v
    projections and norms replicated; the KV cache [B, S, KV, hd] splits
    its batch 32 ways and its sequence 8 ways; lengths and tokens split
    their batch 32 ways."""
    got = run[0]["full"]
    cfg = jcfgs.get_config("proxy-8b")
    params = jax.eval_shape(lambda: jzoo.build(cfg).init_params(
        jax.random.PRNGKey(0)))
    split = ("wq", "wo", "wi", "wg", "embed", "lm_head")
    want = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [getattr(k, "key", "") for k in path]
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        want += n // 8 if any(k in split for k in keys[-2:]) else n
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    Bq, Sq = 128, 32768
    want += 2 * L * (Bq // 32) * (Sq // 8) * KV * hd * 2     # k, v (bf16)
    want += 4 * Bq // 32 + 4 * Bq // 32                      # len, tokens
    assert got["mesh"] == "32x8" and got["chips"] == 256
    assert got["memory_per_device"]["argument_bytes"] == want
    assert got["detail"]["kernel_launches"] == {
        "decode_attention": cfg.num_layers}


def test_main_appends_records_that_render(run):
    got, _, job, log = run
    assert got["main_rc"] == [0, 0]
    assert "[OK] qwen3-smoke × decode_32k × 32x8" in log
    import json
    recs = json.loads(Path(job["json"]).read_text())
    assert len(recs) == 2 and all(r["ok"] for r in recs)
    assert set(recs[0]) >= {"arch", "shape", "mesh", "chips", "ok",
                            "compile_s", "multi_pod", "t_compute_s",
                            "memory_per_device", "detail"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.report_roofline", job["json"]],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=f"src:{ROOT}"),
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("| qwen3-smoke | decode_32k |") == 2


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------


class Hook:
    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.prev, kernels.WORK_HOOK = kernels.WORK_HOOK, self
        return self

    def __exit__(self, *exc):
        kernels.WORK_HOOK = self.prev

    def __call__(self, name, flops, nbytes):
        self.calls.append((name, flops, nbytes))


def _rand(shape, dtype=torch.float32, dev="cpu"):
    g = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=g).to(dtype).to(dev)


def _meta(*ts):
    return [t.to("meta") for t in ts]


def _launches():
    return (dec_ops.LAUNCHES, flash_ops.LAUNCHES, rglru_ops.LAUNCHES,
            rglru_ops.REVERSE_LAUNCHES, rwkv_ops.LAUNCHES)


def _same(meta_out, cpu_out):
    if isinstance(cpu_out, tuple):
        assert len(meta_out) == len(cpu_out)
        for m, c in zip(meta_out, cpu_out):
            _same(m, c)
        return
    assert meta_out.is_meta
    assert (meta_out.shape, meta_out.dtype) == (cpu_out.shape, cpu_out.dtype)


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_meta_route(dtype, lse):
    Bq, Smax, H, KV, hd = 3, 40, 8, 2, 64
    q = _rand((Bq, 1, H, hd), dtype)
    kc, vc = _rand((Bq, Smax, KV, hd), dtype), _rand((Bq, Smax, KV, hd),
                                                      dtype)
    lengths = torch.tensor([5, 40, 17], dtype=torch.int32)
    before = _launches()
    with Hook() as h:
        cpu = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=lse)
        assert h.calls == []                     # the plain version
        meta = dec_ops.flash_decode(*_meta(q, kc, vc, lengths),
                                    return_lse=lse)
    _same(meta, cpu)
    es = q.element_size()
    keys = Bq * Smax                              # full lengths on meta
    assert h.calls == [("decode_attention", 4.0 * keys * H * hd,
                        2 * Bq * H * hd * es + 2 * keys * KV * hd * es
                        + 4 * Bq + (4 * Bq * H if lse else 0))]
    assert _launches() == before


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("window", [0, 7])
def test_flash_meta_route(window, grad):
    Bq, Sq, Skv, H, KV, hd = 2, 12, 20, 4, 2, 64
    q, k, v = (_rand((Bq, Sq, H, hd)), _rand((Bq, Skv, KV, hd)),
               _rand((Bq, Skv, KV, hd)))
    before = _launches()
    cpu = flash_ops.flash_attention(q, k, v, window=window)
    mq, mk, mv = (t.requires_grad_(grad) for t in _meta(q, k, v))
    with Hook() as h:
        meta = flash_ops.flash_attention(mq, mk, mv, window=window)
        if grad:           # the backward: the plain recompute, on meta
            dq, dk, dv = torch.autograd.grad(meta.sum(), (mq, mk, mv))
            assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape,
                                                      v.shape)
    _same(meta.detach(), cpu)
    assert h.calls == [("flash_attention", *[float(x) for x in
                                             flash_ops.work(q, k, True,
                                                            window)])]
    assert h.calls[0][1] == 4.0 * Bq * H * hd * flash_ops.pairs(
        Sq, Skv, True, window)
    assert _launches() == before


@pytest.mark.parametrize("grad", [False, True])
def test_rglru_meta_route_and_reverse(grad):
    Bq, Sq, W = 2, 9, 16
    a, b, h0 = (torch.rand((Bq, Sq, W)), _rand((Bq, Sq, W)),
                _rand((Bq, W)))
    cpu = rglru_ops.rglru_scan(a, b, h0)
    before = _launches()
    ma, mb, mh = (t.requires_grad_(grad) for t in _meta(a, b, h0))
    with Hook() as h:
        meta = rglru_ops.rglru_scan(ma, mb, mh)
        if grad:           # the backward: K4's reverse, on its meta route
            g = torch.autograd.grad(meta[0].sum(), (ma, mb, mh))
            assert [t.shape for t in g] == [a.shape, b.shape, h0.shape]
    _same(tuple(t.detach() for t in meta), cpu)
    n = Bq * Sq * W
    want = [("rglru_scan", 2.0 * n, 12.0 * n + 8 * Bq * W)]
    if grad:
        want.append(("rglru_scan_bwd", 3.0 * n + Bq * W,
                     (4 + 4 + 8 + 4) * n + 4 * 3 * Bq * W))
    assert h.calls == want
    assert _launches() == before


@pytest.mark.parametrize("hd", [16, 64])
def test_rwkv6_meta_route(hd):
    Bq, Sq, H = 2, 5, 3
    r, k, v = (_rand((Bq, Sq, H, hd)) for _ in range(3))
    w = torch.rand((Bq, Sq, H, hd))
    u, s0 = _rand((H, hd)), _rand((Bq, H, hd, hd))
    cpu = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
    before = _launches()
    with Hook() as h:
        meta = rwkv_ops.rwkv6_scan(*_meta(r, k, v, w, u, s0))
    _same(meta, cpu)
    n = Bq * Sq * H * hd
    assert h.calls == [("rwkv6_scan", 5.0 * n * hd,
                        3 * 4 * n + 8 * n + 4 * H * hd + 8 * Bq * H * hd * hd)]
    assert _launches() == before


def _rejects(cuda_fn, meta_fn, args, kw=None):
    """The CUDA wrapper (its checks run before the library loads) and the
    meta route refuse ``args`` alike."""
    def on(t, dev):          # the same strides and storage offset
        n = t.untyped_storage().nbytes() // t.element_size()
        return torch.empty(n, dtype=t.dtype, device=dev).as_strided(
            t.shape, t.stride(), t.storage_offset())

    kw = kw or {}
    errs = []
    for fn, dev in ((cuda_fn, "cpu"), (meta_fn, "meta")):
        with pytest.raises((ValueError, TypeError)) as e:
            fn(*[on(a, dev) for a in args], **kw)
        errs.append((e.type, str(e.value)))
    assert errs[0] == errs[1]


def test_meta_routes_reject_what_the_kernels_reject():
    bf = torch.bfloat16
    q, kc = torch.zeros((2, 1, 8, 48)), torch.zeros((2, 16, 2, 48))
    _rejects(dec_ops.decode_attention_cuda, dec_ops.decode_attention_meta,
             (q, kc, kc, torch.ones(2)))                          # hd 48
    q, kc = torch.zeros((2, 1, 34, 64)), torch.zeros((2, 16, 2, 64))
    _rejects(dec_ops.decode_attention_cuda, dec_ops.decode_attention_meta,
             (q, kc, kc, torch.ones(2)))                          # G = 17
    q = torch.zeros((2, 1, 4, 64), dtype=bf)
    kc = torch.zeros((2, 16, 2, 64), dtype=bf)
    off = torch.zeros(kc.numel() + 1, dtype=bf)[1:].view(kc.shape)
    _rejects(dec_ops.decode_attention_cuda, dec_ops.decode_attention_meta,
             (q, kc, off, torch.ones(2)))          # a base off 16 bytes
    _rejects(dec_ops.decode_attention_cuda, dec_ops.decode_attention_meta,
             (q.half(), kc.half(), kc.half(), torch.ones(2)))     # fp16
    q, k = torch.zeros((1, 8, 65, 256), dtype=bf), torch.zeros(
        (1, 8, 1, 256), dtype=bf)
    _rejects(flash_ops.flash_attention_cuda, flash_ops.flash_attention_meta,
             (q, k, k))                             # G = 65 > BM at hd 256
    q, k = torch.zeros((1, 8, 2, 96)), torch.zeros((1, 8, 2, 96))
    _rejects(flash_ops.flash_attention_cuda, flash_ops.flash_attention_meta,
             (q, k, k))                                           # hd 96
    k = torch.zeros((1, 8, 2, 64), dtype=bf)
    q = torch.zeros((1, 8, 4, 68), dtype=bf)[..., :64]  # rows 136 bytes
    _rejects(flash_ops.flash_attention_cuda, flash_ops.flash_attention_meta,
             (q, k, k))
    a = torch.zeros((2, 8, 16))
    _rejects(rglru_ops.rglru_scan_cuda, rglru_ops.rglru_scan_meta,
             (a, a, torch.zeros((2, 8))))                     # h0 shape
    _rejects(rglru_ops.rglru_scan_cuda, rglru_ops.rglru_scan_meta,
             (a.half(), a.half(), torch.zeros((2, 16))))          # fp16
    _rejects(rglru_ops.rglru_scan_bwd_cuda, rglru_ops.rglru_scan_bwd_meta,
             (a, a[:, :4], torch.zeros((2, 16)), a, torch.zeros((2, 16))))
    r = torch.zeros((1, 4, 2, 32))
    _rejects(rwkv_ops.rwkv6_scan_cuda, rwkv_ops.rwkv6_scan_meta,
             (r, r, r, r, torch.zeros((2, 32)),
              torch.zeros((1, 2, 32, 32))))                       # hd 32


# ---------------------------------------------------------------------------
# the sequence-sharded cache write
# ---------------------------------------------------------------------------


def _old_write(ck, cv, kn, vn, loc):
    """The boolean-mask write ``write_kv_sharded`` made before."""
    chunk = ck.shape[1]
    ok = (loc >= 0) & (loc < chunk)
    b = torch.arange(ck.shape[0])[ok]
    ck[b, loc[ok]] = kn[ok, 0].to(ck.dtype)
    cv[b, loc[ok]] = vn[ok, 0].to(cv.dtype)


class Ops(TorchDispatchMode):
    """Records the names of the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_write_is_the_old_write(dtype):
    """Rows whose position lies before, inside and past a rank's chunk
    (the non-owner and owner cases of every rank), in the cache's dtype
    and from fp32 k / v."""
    rng = np.random.default_rng(3)
    Bq, chunk, KV, hd = 6, 8, 2, 4
    for rank in range(3):
        ck = torch.from_numpy(rng.standard_normal((Bq, chunk, KV, hd)).astype(
            np.float32)).to(dtype)
        cv = torch.from_numpy(rng.standard_normal((Bq, chunk, KV, hd)).astype(
            np.float32)).to(dtype)
        kn = torch.from_numpy(rng.standard_normal((Bq, 1, KV, hd)).astype(
            np.float32))
        vn = torch.from_numpy(rng.standard_normal((Bq, 1, KV, hd)).astype(
            np.float32))
        start = torch.tensor([0, 7, 8, 15, 16, 23])
        loc = start - rank * chunk
        old_k, old_v = ck.clone(), cv.clone()
        _old_write(old_k, old_v, kn, vn, loc)
        with Ops() as ops:
            dec_ops.write_rows_owned(ck, cv, kn, vn, loc)
        assert torch.equal(ck, old_k) and torch.equal(cv, old_v)
        assert not any("nonzero" in n for n in ops.names), ops.names
    mk, mv = _meta(ck, cv)
    dec_ops.write_rows_owned(mk, mv, *_meta(kn, vn, loc))
    assert mk.is_meta and mk.shape == ck.shape
