"""The port's mesh path held to the JAX package on a world of two CPU
ranks (gloo; the rendezvous is a ``FileStore`` under the test's temporary
directory, so parallel test workers never share a port).

One spawn of two ranks (``tests/_torch_mesh_worker.py``) runs every
check of the port; the JAX package's two-device references run in a
process of their own with two forced host devices
(``tests/_jax_mesh_ref.py``), its one-device references here.  Inputs
are drawn from seeds with numpy; params are the JAX package's, bridged.
Both sides run in fp32.

  * the sequence-sharded decode (shard-local write, K1's plain version
    with lse on each rank's chunk, logsumexp combine) against JAX's dense
    path and its two-device sharded path: output within 1e-4, cache
    write exact;
  * the prefill and decode cells of five smoke models on a (data=1,
    model=2) mesh (weights TP-sharded, caches sequence-sharded,
    qwen2-vl's 7 heads zero-padded to 8) against JAX's one-device logits
    within 2e-4;
  * the expert-parallel MoE layers of two smoke models on (1, 2) and
    (2, 1) against JAX at the same mesh (the expert capacity follows the
    local token count): logits within 2e-4, aux loss within 1e-6;
  * one train step through ``launch/train.py --model-parallel 2
    --backend gloo`` (fp32 proxy-8b smoke model, resumed from JAX's
    initial state) against JAX's Trainer on the same batch: loss within
    1e-5 (relative), params within 2e-4.  Its checkpoint has the files,
    paths, shapes and dtypes of the one ``--model-parallel 1`` writes
    from the same start, values within 2e-4 of it, and its bytes are
    what the one-process writer makes of the same state.  The two runs'
    values are not bit-equal: a row-parallel product sums its halves on
    two ranks (7.8e-6 apart at most after two steps on this model).
  * recurrentgemma-9b's train step cell on the (1, 2) mesh against its
    one-rank step and JAX's step: loss and grad norm within 1e-5
    (relative).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 24
CELLS = {"proxy-8b": {}, "qwen2-vl-7b": {"num_heads": 7, "num_kv_heads": 1},
         "whisper-base": {}, "rwkv6-1.6b": {}, "recurrentgemma-9b": {}}
MOE = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
TIMEOUT = 420
TRAIN = ["--device", "cpu", "--backend", "gloo", "--dtype", "float32",
         "--arch", "proxy-8b", "--steps", "1", "--batch", "2", "--seq", "16",
         "--lr", "1e-3", "--ckpt-every", "1"]
STEP_TOL = 1e-5
PARAM_TOL = 2e-4
_RUN_TRAIN = ("import json, sys; from repro_torch.launch import train; "
              "out = train.run(sys.argv[1:]); "
              "print('HISTORY', json.dumps(out['history']), "
              "out['resumed_from'])")


def _cfg(arch, overrides=None):
    return dataclasses.replace(jcfgs.get_smoke_config(arch), dtype="float32",
                               **(overrides or {}))


def _params(cfg, seed):
    p = jzoo.build(cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _cell_batches(cfg, rng):
    n_tok = S - cfg.num_patches if cfg.frontend == "patches" else S
    pre = {"tokens": rng.integers(3, cfg.vocab_size, (B, n_tok),
                                  dtype=np.int32),
           "lengths": np.asarray([n_tok, n_tok - 3], np.int32)}
    dec = {"tokens": rng.integers(3, cfg.vocab_size, (B, 1),
                                  dtype=np.int32)}
    if cfg.frontend == "patches":
        pre["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None],
                              (B, S, 3))
        pre["positions"] = np.ascontiguousarray(pos)
        dec["positions"] = np.broadcast_to(
            pre["lengths"][:, None, None], (B, 1, 3)).astype(np.int32)
    if cfg.frontend == "frames":
        pre["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return pre, dec


def _jax_cell(cfg, params, pre, dec):
    model = jzoo.build(cfg)
    p = jax.tree.map(jnp.asarray, params)
    out = model.apply(p, {k: jnp.asarray(v) for k, v in pre.items()},
                      mode="prefill", cache=model.init_cache(B, S))
    l1 = model.logits_of(p, out["last_hidden"])
    out2 = model.apply(p, {k: jnp.asarray(v) for k, v in dec.items()},
                       mode="decode", cache=out["cache"])
    l2 = model.logits_of(p, out2["hidden"][:, 0])
    return np.asarray(l1), np.asarray(l2)


def _decode_unit():
    rng = np.random.default_rng(0)
    Smax, H, KV, hd = 64, 8, 2, 16
    d = {"q": (B, 1, H, hd), "ck": (B, Smax, KV, hd), "cv": (B, Smax, KV, hd),
         "kn": (B, 1, KV, hd), "vn": (B, 1, KV, hd)}
    d = {k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()}
    d["lengths"] = np.asarray([10, 33], np.int32)
    return d


def _rg_train(rng):
    """recurrentgemma-9b's smoke train step (fp32) from JAX's initial
    state: the job for the ranks, and the loss and grad norm of JAX's step
    and of the port's one-rank step on the same state and batch."""
    from repro_torch import bridge
    from repro_torch.models import model_zoo
    from repro_torch.train.train_step import make_train_step
    arch = "recurrentgemma-9b"
    cfg = _cfg(arch)
    jm = jzoo.build(cfg)
    state = jax.tree.map(np.asarray, jstep.init_state(
        jm, jax.random.PRNGKey(3)).tree())
    tok = rng.integers(3, cfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": tok, "labels": tok,
             "loss_mask": np.ones((B, S), np.float32)}
    _, jmet = jstep.make_train_step(jm, joptim.AdamWConfig())(
        jax.tree.map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    from repro_torch.configs import base as tcfgs
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch), dtype="float32")
    _, tmet = make_train_step(model_zoo.build(tcfg), grad_accum=1)(
        bridge.state_from_jax(tcfg, state),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    keys = ("loss", "grad_norm")
    return ({"arch": arch, "state": state, "batch": batch, "B": B, "S": S},
            {"jax": {k: float(jmet[k]) for k in keys},
             "one": {k: float(tmet[k]) for k in keys}})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(1)
    job = {"decode_unit": _decode_unit(), "cells": [], "moe": []}
    ref = {"cells": {}}
    for i, (arch, over) in enumerate(CELLS.items()):
        cfg = _cfg(arch, over)
        params = _params(cfg, i)
        pre, dec = _cell_batches(cfg, rng)
        job["cells"].append({"name": arch, "arch": arch, "overrides": over,
                             "params": params, "prefill": pre,
                             "decode": dec, "B": B, "S": S})
        ref["cells"][arch] = _jax_cell(cfg, params, pre, dec)
    for i, arch in enumerate(MOE):
        cfg = _cfg(arch)
        job["moe"].append({
            "arch": arch, "params": _params(cfg, 10 + i),
            "batch": {"tokens": rng.integers(3, cfg.vocab_size, (B, 8),
                                             dtype=np.int32)}})
    job["rg_train"], ref["rg_train"] = _rg_train(rng)
    job_path, out_path = tmp / "job.pkl", tmp / "out.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    # the train runs start from JAX's initial state, checkpointed at step 0
    jm = jzoo.build(_cfg("proxy-8b"))
    state0 = jstep.init_state(jm, jax.random.PRNGKey(0)).tree()
    for mp in (1, 2):
        jckpt.CheckpointManager(str(tmp / f"mp{mp}")).save(0, state0)
    src = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {
        "jax2": subprocess.Popen(
            [sys.executable, str(ROOT / "tests/_jax_mesh_ref.py"),
             str(job_path), str(tmp / "jax.pkl")],
            env=dict(src, JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=2"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "ranks": subprocess.Popen(
            [sys.executable, str(ROOT / "tests/_torch_mesh_worker.py"),
             str(job_path), str(out_path), str(tmp / "store")],
            env=dict(src, MESH_WORKER_TIMEOUT=str(TIMEOUT - 60)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for mp in (1, 2):
        procs[f"mp{mp}"] = subprocess.Popen(
            [sys.executable, "-c", _RUN_TRAIN] + TRAIN + [
                "--model-parallel", str(mp), "--ckpt-dir", str(tmp / f"mp{mp}")],
            env=dict(src, REPRO_RANK_TIMEOUT=str(TIMEOUT - 60)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref["train"] = jloop.Trainer(
        jm, jdata.TokenPipeline(jm.cfg.vocab_size, seq_len=16,
                                global_batch=2, seed=0),
        jckpt.CheckpointManager(str(tmp / "jax_train")),
        loop=jloop.LoopConfig(total_steps=1, checkpoint_every=1),
        opt=joptim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=1),
        seed=0).run()
    ref["state0"] = state0
    ref["tmp"] = tmp
    outs = {}
    for name, p in procs.items():
        try:
            outs[name], _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, (name, outs[name][-4000:])
    ref["train_out"] = {mp: outs[f"mp{mp}"] for mp in (1, 2)}
    ranks = []
    for r in range(2):
        with open(f"{out_path}.{r}", "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[r], ranks[r]["error"]
    with open(tmp / "jax.pkl", "rb") as f:
        ref["jax2"] = pickle.load(f)
    ref["job"] = job
    return ranks, ref


def test_sharded_decode_matches_jax_dense_and_two_device(run):
    ranks, ref = run
    d = {k: jnp.asarray(v) for k, v in ref["job"]["decode_unit"].items()}
    ck, cv = jattn.write_kv(d["ck"], d["cv"], d["kn"], d["vn"],
                            d["lengths"] - 1)
    dense = np.asarray(jattn.decode_attention(d["q"], ck, cv, d["lengths"]))
    two = ref["jax2"]["decode_unit"]
    for r in ranks:
        got = r["decode_unit"]
        np.testing.assert_allclose(got["out"], dense, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["out"], two["out"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(got["ck"], np.asarray(ck))
        np.testing.assert_array_equal(got["cv"], np.asarray(cv))
        np.testing.assert_array_equal(got["ck"], two["ck"])
        assert np.isfinite(got["empty"]).all()
        assert not got["empty"][1].any()       # a row with no valid key


@pytest.mark.parametrize("arch", list(CELLS))
def test_cells_match_jax(run, arch):
    ranks, ref = run
    j_pre, j_dec = ref["cells"][arch]
    for r in ranks:
        got = r["cells"][arch]
        np.testing.assert_allclose(got["prefill"], j_pre, **TOL)
        np.testing.assert_allclose(got["decode"], j_dec, **TOL)
        np.testing.assert_array_equal(
            got["len"], ref["job"]["cells"][list(CELLS).index(arch)]
            ["prefill"]["lengths"] + 1)
        # the weights are TP-sharded
        assert got["split_leaves"] >= got["leaves"] // 3
        # every self-attention layer decoded through the sharded path
        cfg = _cfg(arch, CELLS[arch])
        n_attn = (cfg.num_layers if cfg.is_encoder_decoder else
                  sum(b in ("attn", "local") for b in cfg.block_pattern))
        assert got["sharded_decodes"] == n_attn


def test_mesh_step_roofline_counts_collectives(run):
    ranks, _ = run
    for r in ranks:
        roof = r["cells"]["proxy-8b"]["roofline"]
        # per layer: the sharded decode's MAX and two SUMs, the
        # row-parallel products' sums
        assert roof["collectives"].get("all-reduce", 0) >= 3 * 2
        assert roof["collective_bytes_per_dev"] > 0
        assert roof["hlo_flops_per_dev"] > 0
        assert 0.0 <= roof["mfu_bound"] <= 1.0
        assert (roof["mesh"], roof["chips"]) == ("1x2", 2)
        by_axis = roof["detail"]["collective_by_axis"]
        assert sum(by_axis.values()) == pytest.approx(
            roof["collective_bytes_per_dev"])
        # two cards lie inside a node: every wire byte crosses NVLink
        assert roof["t_collective_s"] == pytest.approx(
            roof["collective_bytes_per_dev"] / 450e9)


def test_recurrentgemma_train_step_on_two_ranks(run):
    """recurrentgemma-9b's train step on the (1, 2) mesh (RG-LRU width and
    its a_param sharded over ``model``) against its one-rank step and
    JAX's step on the same state and batch."""
    ranks, ref = run
    want = ref["rg_train"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(want["one"][k], want["jax"][k],
                                   rtol=STEP_TOL)
        for r in ranks:
            np.testing.assert_allclose(r["rg_train"][k], want["one"][k],
                                       rtol=STEP_TOL)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
@pytest.mark.parametrize("arch", MOE)
def test_expert_parallel_moe_matches_jax(run, arch, mesh):
    ranks, ref = run
    want = ref["jax2"]["moe"][(arch, mesh)]
    for r in ranks:
        got = r["moe"][(arch, mesh)]
        np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=0,
                                   atol=1e-6)
        assert got["ep_layers"] == _cfg(arch).num_layers


def _history(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("HISTORY"))
    hist, resumed = line[len("HISTORY "):].rsplit(" ", 1)
    import json
    return json.loads(hist), resumed


def test_model_parallel_train_step_matches_jax(run):
    _, ref = run
    hist, resumed = _history(ref["train_out"][2])
    assert resumed == "0"
    want = ref["train"]["history"]
    assert len(hist) == len(want) == 1
    np.testing.assert_allclose(hist[0]["loss"], want[0]["loss"],
                               rtol=STEP_TOL)
    np.testing.assert_allclose(hist[0]["grad_norm"], want[0]["grad_norm"],
                               rtol=STEP_TOL)
    got = jckpt.CheckpointManager(str(ref["tmp"] / "mp2")).restore(
        1, ref["state0"])
    jw = jax.tree_util.tree_leaves_with_path(ref["train"]["state"]["params"])
    gw = dict(jax.tree_util.tree_leaves_with_path(got["params"]))
    for path, leaf in jw:
        np.testing.assert_allclose(np.asarray(gw[path]), np.asarray(leaf),
                                   rtol=0, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_model_parallel_checkpoint_is_the_one_rank_format(run):
    import json
    from repro_torch.train import checkpoint as tckpt
    _, ref = run
    tmp = ref["tmp"]
    one, two = tmp / "mp1" / "step_00000001", tmp / "mp2" / "step_00000001"
    assert sorted(p.name for p in one.iterdir()) == \
        sorted(p.name for p in two.iterdir())
    m1 = json.loads((one / "MANIFEST.json").read_text())
    m2 = json.loads((two / "MANIFEST.json").read_text())
    assert m1["step"] == m2["step"] == 1
    assert {k: (v["shape"], v["dtype"]) for k, v in m1["leaves"].items()} \
        == {k: (v["shape"], v["dtype"]) for k, v in m2["leaves"].items()}
    for name in m1["leaves"]:
        f = name.replace("/", "__") + ".npy"
        np.testing.assert_allclose(np.load(two / f), np.load(one / f),
                                   rtol=0, atol=PARAM_TOL, err_msg=name)
    # rank 0 wrote the whole state, in the one-process writer's bytes
    state = jckpt.CheckpointManager(str(tmp / "mp2")).restore(
        1, ref["state0"])
    again = tckpt.CheckpointManager(str(tmp / "rewrite"))
    again.save(1, jax.tree.map(np.asarray, state))
    for p in two.iterdir():
        assert p.read_bytes() == (tmp / "rewrite" / "step_00000001" /
                                  p.name).read_bytes(), p.name
