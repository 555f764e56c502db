"""The port's training path (``repro_torch.train``, ``launch/train.py``)
held to the JAX package's on the CPU; ``test_torch_train_grads.py``
holds the gradients of ``loss_fn``.

Both sides run fp32 smoke configs (``dataclasses.replace(cfg, dtype=
"float32")``) on params converted from JAX (``bridge.params_from_jax``,
with nonzero biases and norm scales), on the same numpy batches.
Tolerances, set from the dtype before the first run:

  * train steps: losses and metrics within 1e-5 (relative) after each
    of three AdamW steps, the first moments (sums of gradients) within
    the gradients' 1e-4 of their leaf's largest value, and each leaf's
    update (params after the steps minus before) within 1e-2 of the
    leaf's largest update.  Not the params
    within 1e-5 absolute: Adam divides each gradient element by its own
    root mean square, so a rounding difference in an element near
    ``eps`` (a gradient of 8e-9 in a leaf whose largest is 1.5e-2) moves
    its param by a fraction of the learning rate (2.1e-5 read at lr
    3e-3, 1.03e-5 at 1e-3), whatever the leaf's scale.  ``adamw_update``
    itself is held to 1e-6 on the same gradients;
  * AdamW alone: params and moments within 1e-6 (elementwise fp32, the
    same order of operations; bf16 params equal after the cast), the
    schedule within 1e-9 of its peak;
  * the token pipeline and the checkpoint files: bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import _torch_train_common as tt  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

GRAD_TOL = 1e-4
STEP_TOL = 1e-5
UPDATE_TOL = 1e-2
ADAMW_TOL = 1e-6


# ---------------------------------------------------------------------------
# train steps, AdamW, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(accum):
    """Three steps of make_train_step (and its metrics), grad_accum 1 and
    2, from the same params and batches."""
    jm, tm = tt.pair("proxy-8b")
    cfg = tm.cfg
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    jstate = tt.jstate(jm, 2)
    tstate = {"params": bridge.params_from_jax(
        cfg, jax.tree.map(np.asarray, jstate["params"]))}
    tstate["opt_state"] = toptim.adamw_init(tstate["params"])
    tstate["step"] = torch.zeros((), dtype=torch.int32)
    p0 = jstate["params"]
    jfn = jax.jit(jstep.make_train_step(jm, joptim.AdamWConfig(**opt),
                                        grad_accum=accum))
    tfn = tstep.make_train_step(tm, toptim.AdamWConfig(**opt),
                                grad_accum=accum)
    for i in range(3):
        jb, tb = tt.batch(cfg, 10 + i, 4, 16)
        jstate, jm_ = jfn(jstate, jb)
        tstate, tm_ = tfn(tstate, tb)
        assert jm_.keys() == tm_.keys()
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=STEP_TOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        if accum > 1:
            assert float(tm_["aux"]) == float(tm_["tokens"]) == 0.0
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    tt.hold_updates(tstate["params"], jstate["params"], p0, cfg, UPDATE_TOL)
    tt.hold_leaves(tstate["opt_state"]["mu"], jstate["opt_state"]["mu"], cfg,
                 GRAD_TOL, "mu")


def test_eval_step_matches_loss_fn():
    jm, tm = tt.pair("proxy-8b")
    jparams = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(tm.cfg, jax.tree.map(np.asarray,
                                                          jparams))
    jb, tb = tt.batch(tm.cfg, 1, 2, 8)
    jout = jstep.make_eval_step(jm)(jparams, jb)
    tout = tstep.make_eval_step(tm)(tparams, tb)
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 100, 130])
def test_schedule_matches_jax(step):
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=100)
    j = float(joptim.schedule(joptim.AdamWConfig(**cfg), step))
    t = float(toptim.schedule(toptim.AdamWConfig(**cfg), step))
    assert abs(t - j) <= 1e-9 * 1e-2 * 100, (t, j)


@pytest.mark.parametrize("clip", [1.0, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(clip, dtype):
    """Three updates with clipping on (norm 1 against grads of norm ~40)
    and off, on fp32 and bf16 params."""
    rng = np.random.default_rng(7)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip_norm=clip)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 2, 4)}}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def draw(s, scale=1.0):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)

    p0 = jax.tree.map(lambda a: jnp.asarray(a, jdt), draw(shapes),
                      is_leaf=lambda x: isinstance(x, np.ndarray))
    jp, js = p0, joptim.adamw_init(p0)
    tp = jax.tree.map(lambda a: bridge.tensor_from_numpy(np.asarray(a)), p0)
    ts = toptim.adamw_init(tp)
    for _ in range(3):
        g = draw(shapes, 10.0)
        jp, js, jmet = joptim.adamw_update(
            joptim.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tmet = toptim.adamw_update(
            toptim.AdamWConfig(**cfg),
            jax.tree.map(torch.from_numpy, g), ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=ADAMW_TOL)
    assert (float(jmet["grad_norm"]) > clip) == (clip == 1.0)
    assert int(ts["count"]) == int(js["count"]) == 3
    for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]),
                           (ts["nu"], js["nu"])):
        for t, j in zip(toptim.leaves(tree_t), jax.tree.leaves(tree_j)):
            assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                               else torch.float32)
            np.testing.assert_allclose(tt.as_np(t), tt.as_np(j), rtol=ADAMW_TOL,
                                       atol=ADAMW_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(num_shards=2, shard_id=1),
                                dict(seed=3, eff_vocab=77)])
def test_token_pipeline_bitwise(kw):
    for step in (0, 4, 1000):
        j = jdata.TokenPipeline(50000, 33, 8, **kw).batch_at(step)
        t = tdata.TokenPipeline(50000, 33, 8, **kw).batch_at(step)
        assert j.keys() == t.keys()
        for k in j:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])


# ---------------------------------------------------------------------------
# checkpoints and the loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv():
    """rwkv6's bf16 smoke model in both packages (bf16 and fp32 leaves)."""
    return tt.pair("rwkv6-1.6b", fp32=False)


def _tstate(model, seed=0):
    return tstep.init_state(model, seed, "cpu").tree()


def test_state_layout_round_trip(rwkv):
    """state_to_jax gives the JAX tree's paths, shapes and dtypes, and
    state_from_jax inverts it bit for bit."""
    jm, tm = rwkv
    jtree = tt.jstate(jm, 0)
    st = _tstate(tm)
    lay = bridge.state_to_jax(tm.cfg, st)
    jflat = jckpt._leafpaths(jtree)
    tflat = tckpt._leafpaths(lay)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (_, j), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    dts = tckpt._leafpaths(bridge.state_dtypes(tm.cfg, st))
    assert [d for _, d in dts] == [t.dtype for _, t in tflat]
    back = bridge.state_from_jax(tm.cfg, lay)
    for a, b in zip(toptim.leaves(back), toptim.leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_round_trip_and_files_match_jax(tmp_path, rwkv):
    """A port checkpoint of JAX's state has JAX's manifest (paths, files,
    shapes, dtypes, hashes): the same bytes on disk; each package
    restores the other's bit for bit."""
    jm, tm = rwkv
    jtree = tt.jstate(jm, 0)
    port_tree = jax.tree.map(
        lambda a: bridge.tensor_from_numpy(np.asarray(a)), jtree)
    jp = jckpt.CheckpointManager(str(tmp_path / "j")).save(5, jtree)
    tmgr = tckpt.CheckpointManager(str(tmp_path / "t"))
    tp = tmgr.save(5, port_tree)
    with open(os.path.join(jp, "MANIFEST.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tp, "MANIFEST.json")) as f:
        tman = json.load(f)
    assert jman == tman
    assert "bfloat16" in {m["dtype"] for m in tman["leaves"].values()}
    like = bridge.state_dtypes(tm.cfg, _tstate(tm))
    got = tckpt.CheckpointManager(str(tmp_path / "j")).restore(5, like)
    back = jckpt.CheckpointManager(str(tmp_path / "t")).restore(5, jtree)
    for t, j, jb in zip(tckpt._leafpaths(got), jckpt._leafpaths(jtree),
                        jckpt._leafpaths(back)):
        assert t[0] == j[0]
        a = np.asarray(j[1])
        b = np.asarray(jb[1])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))
        if a.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(
                t[1].view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t[1].numpy(), a)


def test_checkpoint_integrity_rejects_corruption(tmp_path, rwkv):
    _, tm = rwkv
    lay = bridge.state_to_jax(tm.cfg, _tstate(tm))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    path = mgr.save(1, lay)
    victim = next(f for f in sorted(os.listdir(path)) if f.endswith(".npy"))
    fp = os.path.join(path, victim)
    data = bytearray(open(fp, "rb").read())
    data[-1] ^= 0xFF
    open(fp, "wb").write(bytes(data))
    with pytest.raises(tckpt.CheckpointCorrupt):
        mgr.restore(1, lay)
    assert mgr.restore_latest(lay) is None


def test_restore_latest_skips_corrupt(tmp_path, rwkv):
    _, tm = rwkv
    lay = bridge.state_to_jax(tm.cfg, _tstate(tm))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, lay)
    p2 = mgr.save(2, lay)
    victim = next(f for f in sorted(os.listdir(p2)) if f.endswith(".npy"))
    open(os.path.join(p2, victim), "wb").write(b"garbage")
    step, _ = mgr.restore_latest(lay)
    assert step == 1


def test_checkpoint_retention(tmp_path, rwkv):
    _, tm = rwkv
    lay = bridge.state_to_jax(tm.cfg, _tstate(tm))
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, lay)
    assert mgr.all_steps() == [3, 4]


def test_crash_restart_matches_uninterrupted(tmp_path, rwkv):
    _, tm = rwkv
    pipe = tdata.TokenPipeline(tm.cfg.vocab_size, seq_len=32, global_batch=2,
                               seed=0)
    loop = tloop.LoopConfig(total_steps=6, checkpoint_every=2)
    opt = toptim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    ref = tloop.Trainer(tm, pipe,
                        tckpt.CheckpointManager(str(tmp_path / "ref")),
                        loop=loop, opt=opt, device="cpu").run()
    inj = tloop.FailureInjector(fail_at_steps=(3,))
    mgr = tckpt.CheckpointManager(str(tmp_path / "crash"))
    out = tloop.run_with_restarts(
        lambda: tloop.Trainer(tm, pipe, mgr, loop=loop, opt=opt,
                              injector=inj, device="cpu"))
    assert out["restarts"] == 1 and out["resumed_from"] == 2
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"][2:]]
    for a, b in zip(toptim.leaves(ref["state"]),
                    toptim.leaves(out["state"])):
        assert torch.equal(a, b)


def test_checkpoints_resume_across_packages(tmp_path):
    """JAX's Trainer checkpoints at step 2 of 4; the port's Trainer
    resumes there and gives JAX's losses for steps 3-4, and the reverse
    (the port writes step 2, JAX resumes)."""
    jm, tm = tt.pair("proxy-8b")
    pipe_kw = dict(vocab_size=tm.cfg.vocab_size, seq_len=16,
                   global_batch=2, seed=1)
    opt = dict(lr=2e-3, warmup_steps=1, total_steps=4)
    ref = jloop.Trainer(jm, jdata.TokenPipeline(**pipe_kw),
                        jckpt.CheckpointManager(str(tmp_path / "ref")),
                        loop=jloop.LoopConfig(total_steps=4,
                                              checkpoint_every=2),
                        opt=joptim.AdamWConfig(**opt)).run()
    ref_losses = [h["loss"] for h in ref["history"]]

    jdir = str(tmp_path / "j2t")
    jloop.Trainer(jm, jdata.TokenPipeline(**pipe_kw),
                  jckpt.CheckpointManager(jdir),
                  loop=jloop.LoopConfig(total_steps=2, checkpoint_every=2),
                  opt=joptim.AdamWConfig(**opt)).run()
    port = tloop.Trainer(tm, tdata.TokenPipeline(**pipe_kw),
                         tckpt.CheckpointManager(jdir),
                         loop=tloop.LoopConfig(total_steps=4,
                                               checkpoint_every=2),
                         opt=toptim.AdamWConfig(**opt), device="cpu").run()
    assert port["resumed_from"] == 2
    np.testing.assert_allclose([h["loss"] for h in port["history"]],
                               ref_losses[2:], rtol=STEP_TOL)
    at2 = jckpt.CheckpointManager(jdir).restore(
        2, tt.jstate(jm, 0))
    tt.hold_updates(port["state"]["params"], ref["state"]["params"],
                    at2["params"], tm.cfg, UPDATE_TOL)

    tdir = str(tmp_path / "t2j")
    tloop.Trainer(tm, tdata.TokenPipeline(**pipe_kw),
                  tckpt.CheckpointManager(tdir),
                  loop=tloop.LoopConfig(total_steps=2, checkpoint_every=2),
                  opt=toptim.AdamWConfig(**opt), device="cpu").run()
    back = jloop.Trainer(jm, jdata.TokenPipeline(**pipe_kw),
                         jckpt.CheckpointManager(tdir),
                         loop=jloop.LoopConfig(total_steps=4,
                                               checkpoint_every=2),
                         opt=joptim.AdamWConfig(**opt)).run()
    assert back["resumed_from"] == 2
    assert len(back["history"]) == 2


def test_launch_train_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", "rwkv6-1.6b", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert tlaunch.main(argv) == 0
    first = capsys.readouterr().out
    assert "arch=rwkv6-1.6b steps=3 loss" in first
    assert "resumed_from=None" in first
    out = tlaunch.run(argv[:5] + ["5"] + argv[6:])
    assert out["resumed_from"] == 3 and len(out["history"]) == 2
    assert "resumed_from=3" in capsys.readouterr().out
    cut = tlaunch.run(["--device", "cpu", "--arch", "recurrentgemma-9b",
                       "--layers", "5", "--steps", "1", "--batch", "2",
                       "--seq", "8", "--ckpt-dir", str(tmp_path / "rg")])
    assert cut["cfg"].num_layers == 5
    # --model-parallel 2 runs (tests/test_torch_mesh.py); its default
    # backend, nccl, needs a card per rank and says so
    with pytest.raises(ValueError, match="nccl"):
        tlaunch.main(["--device", "cpu", "--model-parallel", "2"])
