"""The port's recurrent and sliding-window path (rwkv6-1.6b and
recurrentgemma-9b) held to the JAX package on params converted from JAX
smoke models.

Blocks (RWKV-6, RG-LRU, sliding-window attention), the whole LM (prefill
and decode, with tail blocks and tied, scaled embeddings) and the engine
are compared on the same numpy inputs.  Both sides are built in fp32
(``dataclasses.replace(cfg, dtype="float32")``), so the check is of the
algorithm, not of where bf16 rounds.  Tolerance: rtol/atol 2e-4, that of
``tests/test_torch_model.py`` (the frameworks sum in different orders);
the engine's SCORE and EMBED values within 2e-4 and its token ids, labels,
counts and credits equal.  On the CPU the scans run the plain versions of
K4 and K5, and the ring decode runs K1's plain version under
``use_decode_impl("auto")``: both are held to JAX here.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as jcfgs  # noqa: E402
import repro.inference.tokenizer as jtok  # noqa: E402
from repro.inference.engine import JaxInferenceEngine  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
import repro_torch.configs.base as tcfgs  # noqa: E402
import repro_torch.inference.tokenizer as ttok  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED,  # noqa
                                           SCORE, Request)
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.models import attention, blocks, lm, model_zoo  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
VALUE_TOL = 2e-4
ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b")


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = _fp32(jcfgs.get_smoke_config(arch))
    tcfg = _fp32(tcfgs.get_smoke_config(arch))
    jm = jzoo.build(jcfg)
    jparams = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    tm = model_zoo.build(tcfg)
    tparams = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(
        np.int32)


def _close(t_tree, j_tree):
    """Every leaf of the port's dict tree within TOL of the JAX one."""
    assert set(t_tree) == set(j_tree), (sorted(t_tree), sorted(j_tree))
    for k in t_tree:
        if isinstance(t_tree[k], dict):
            _close(t_tree[k], j_tree[k])
        else:
            np.testing.assert_allclose(_np(t_tree[k]), _np(j_tree[k]),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tcfgs, get)(arch))
                == dataclasses.asdict(getattr(jcfgs, get)(arch)))
    assert arch in tcfgs.PORTED_IDS
    cfg = tcfgs.get_config(arch)
    assert model_zoo.build(arch).cfg == cfg       # full size builds too
    assert len(cfg.block_pattern) == cfg.num_layers


def _leaf_specs(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of arrays, with the
    port's per-layer list keyed like the JAX tree's leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def test_bridge_and_init_layout(models):
    """The port's own init (bf16, the served dtype) has the JAX tree's
    leaves, shapes and dtypes once the period stacks are split into
    layers: RWKV-6's u, w0 and gn_* and RG-LRU's gates stay fp32 beside
    bf16 weights, and tied embeddings leave no ``lm_head``.  The bridge
    puts the tail's blocks after the periods' layers."""
    jm, jparams, tm, tparams = models
    cfg = dataclasses.replace(tm.cfg, dtype="bfloat16")
    jcfg = dataclasses.replace(jm.cfg, dtype="bfloat16")
    jshape = jax.eval_shape(jzoo.build(jcfg).init_params,
                            jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp = model_zoo.build(cfg).init_params(gen)
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    n, n_body = len(cfg.period), cfg.num_periods * len(cfg.period)
    assert len(tp["layers"]) == cfg.num_layers
    for layer, lp in enumerate(tp["layers"]):
        if layer < n_body:
            want = {k: (s[1:], d) for k, (s, d) in _leaf_specs(
                jshape["periods"][f"b{layer % n}"]).items()}
        else:
            want = _leaf_specs(jshape["tail"][f"t{layer - n_body}"])
        assert _leaf_specs(lp) == want, layer
    top = {k: v for k, v in tp.items() if k != "layers"}
    assert _leaf_specs(top) == _leaf_specs(
        {k: v for k, v in jshape.items() if k not in ("periods", "tail")})
    for i in range(len(cfg.tail)):
        np.testing.assert_array_equal(
            _np(tparams["layers"][n_body + i]["rec"]["in_x"]),
            np.asarray(jparams["tail"][f"t{i}"]["rec"]["in_x"]))
    last = cfg.num_periods - 1
    np.testing.assert_array_equal(
        _np(tparams["layers"][last * n]["ln1"]["scale"]),
        np.asarray(jparams["periods"]["b0"]["ln1"]["scale"][last]))


def test_lm_prefill_and_decode_match_jax(models):
    """Ragged prefill (a prompt longer than the smoke window of 32), then
    five single-token decode steps, past the ring's wrap for the row that
    starts at 29 tokens; last hidden states, fp32 logits (tied and
    soft-capped for recurrentgemma) and every cache leaf agree at every
    step.  The decode steps alternate the dense ring attention and the
    flash-decode path (K1's plain version on the CPU).  The JAX side runs
    jitted, as its engine does."""
    jm, jparams, tm, tparams = models
    cfg = tm.cfg
    japply = jax.jit(jm.apply, static_argnames=("mode",))
    B, S, smax = 3, 40, 48
    toks = _tokens(1, B, S, cfg.vocab_size)
    lens = np.array([40, 29, 1], np.int32)
    jc = jm.init_cache(B, smax)
    tc = tm.init_cache(B, smax)
    assert lm.cache_capacity(tc) == (cfg.attention_window
                                     if not cfg.attention_free else 0)
    j = japply(jparams, {"tokens": jnp.asarray(toks),
                         "lengths": jnp.asarray(lens)},
               mode="prefill", cache=jc)
    t = tm.apply(tparams, {"tokens": torch.from_numpy(toks),
                           "lengths": torch.from_numpy(lens)},
                 mode="prefill", cache=tc)
    np.testing.assert_allclose(_np(t["last_hidden"]), _np(j["last_hidden"]),
                               **TOL)
    np.testing.assert_allclose(_np(tm.logits_of(tparams, t["last_hidden"])),
                               _np(jm.logits_of(jparams, j["last_hidden"])),
                               **TOL)
    jc, tc = j["cache"], t["cache"]
    _close(tc, jc)
    for step in range(5):
        nxt = _tokens(10 + step, B, 1, cfg.vocab_size)
        j = japply(jparams, {"tokens": jnp.asarray(nxt)}, mode="decode",
                   cache=jc)
        with attention.use_decode_impl("dense" if step % 2 else "auto"):
            t = tm.apply(tparams, {"tokens": torch.from_numpy(nxt)},
                         mode="decode", cache=tc)
        np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]),
                                   **TOL)
        np.testing.assert_allclose(
            _np(tm.logits_of(tparams, t["hidden"][:, 0])),
            _np(jm.logits_of(jparams, j["hidden"][:, 0])), **TOL)
        jc, tc = j["cache"], t["cache"]
        _close(tc, jc)


def test_train_mode_matches_jax(models):
    jm, jparams, tm, tparams = models
    toks = _tokens(2, 2, 37, tm.cfg.vocab_size)
    j = jax.jit(jm.apply, static_argnames=("mode", "remat"))(
        jparams, {"tokens": jnp.asarray(toks)}, mode="train", remat=False)
    t = tm.apply(tparams, {"tokens": torch.from_numpy(toks)}, mode="train")
    np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
    np.testing.assert_allclose(_np(tm.logits_of(tparams, t["hidden"])),
                               _np(jm.logits_of(jparams, j["hidden"])),
                               **TOL)


# ---------------------------------------------------------------------------
# each block alone: train, prefill, decode
# ---------------------------------------------------------------------------

BLOCKS = [("rwkv6-1.6b", tcfgs.RWKV, 0), ("recurrentgemma-9b", tcfgs.RGLRU, 0),
          ("recurrentgemma-9b", tcfgs.LOCAL_ATTN, 2)]


@pytest.mark.parametrize("arch,blk,pos", BLOCKS)
def test_block_matches_jax(arch, blk, pos):
    """One block of the smoke model (period position ``pos``) in train
    mode, ragged prefill of 40 tokens (longer than the window of 32) and
    then single-token decode steps until the row that started at 29
    tokens has wrapped its ring; outputs and the cache agree at every
    step."""
    jcfg = _fp32(jcfgs.get_smoke_config(arch))
    tcfg = _fp32(tcfgs.get_smoke_config(arch))
    jp = jblocks.block_init(blk, jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: bridge.tensor_from_numpy(np.asarray(a)), jp)
    B, S, smax = 3, 40, 48
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    lens = np.array([40, 29, 3], np.int32)

    @functools.partial(jax.jit, static_argnums=0)
    def japply(mode, xs, positions, lengths, valid, cache):
        ctx = jblocks.Ctx(cfg=jcfg, mode=mode, positions=positions,
                          lengths=lengths, valid=valid, cache=cache,
                          smax=smax)
        y, c, _ = jblocks.block_apply(blk, jp, xs, ctx)
        return y, c

    def run(mode, xs, jcache, tcache, lengths, valid=None):
        Bx, Sx = xs.shape[:2]
        if mode == "decode":
            jpos = jnp.asarray(lengths - 1)[:, None]
        else:
            jpos = jnp.broadcast_to(jnp.arange(Sx, dtype=jnp.int32)[None],
                                    (Bx, Sx))
        jl = None if lengths is None else jnp.asarray(lengths)
        jv = None if valid is None else jnp.asarray(valid)
        jy, jc = japply(mode, jnp.asarray(xs), jpos, jl, jv, jcache)
        tl = None if lengths is None else torch.from_numpy(lengths)
        tv = None if valid is None else torch.from_numpy(valid)
        tctx = blocks.Ctx(cfg=tcfg, mode=mode,
                          positions=torch.from_numpy(np.array(jpos)),
                          lengths=tl, valid=tv, cache=tcache)
        ty, tc, _ = blocks.block_apply(blk, tp, torch.from_numpy(xs), tctx)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        if jc is not None:
            _close(tc, jc)
        return jc, tc

    run("train", x, None, None, None)
    jc = jblocks.block_cache_init(blk, jcfg, B, smax, jnp.float32)
    tc = blocks.block_cache_init(blk, tcfg, B, smax, torch.float32, "cpu")
    valid = np.arange(S)[None] < lens[:, None]
    jc, tc = run("prefill", x, jc, tc, lens, valid)
    steps = 4 if blk == tcfgs.LOCAL_ATTN else 2
    for step in range(steps):
        lens = lens + 1
        xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        with attention.use_decode_impl("auto" if step % 2 else "dense"):
            jc, tc = run("decode", xd, jc, tc, lens)
    if blk == tcfgs.LOCAL_ATTN:
        assert lens[1] > jcfg.attention_window    # the ring wrapped


# ---------------------------------------------------------------------------
# routing: plain versions on the CPU, the switches, the ring as a prefix
# ---------------------------------------------------------------------------


def test_scans_take_the_plain_versions_on_cpu(models):
    """On CPU tensors the model's scans run the plain versions (no launch
    counted), ``use_scan_impl("reference")`` gives the same bits, and an
    unknown impl raises."""
    _, _, tm, tparams = models
    toks = torch.from_numpy(_tokens(5, 2, 9, tm.cfg.vocab_size))
    before = (rglru_ops.LAUNCHES, rwkv_ops.LAUNCHES, dec_ops.LAUNCHES)
    out = tm.apply(tparams, {"tokens": toks}, mode="train")["hidden"]
    with blocks.use_scan_impl("reference"):
        ref = tm.apply(tparams, {"tokens": toks}, mode="train")["hidden"]
    assert torch.equal(out, ref)
    assert (rglru_ops.LAUNCHES, rwkv_ops.LAUNCHES,
            dec_ops.LAUNCHES) == before
    with pytest.raises(ValueError):
        with blocks.use_scan_impl("pallas"):
            pass


@pytest.mark.parametrize("pos", [0, 5, 31, 32, 33, 70])
def test_ring_decode_is_flash_decode_over_a_prefix(pos):
    """The ring's valid slots are its first min(pos+1, W); flash-decode
    over that prefix gives the masked dense ring attention of the JAX
    package, before and after the wrap."""
    W, B, H, KV, hd = 32, 2, 4, 1, 16
    rng = np.random.default_rng(pos)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, 1, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    n = min(pos + 1, W)
    k[:, n:] = 0.0                  # slots never written stay zero
    v[:, n:] = 0.0
    p = np.full((B,), pos, np.int32)
    want = jattn.ring_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(p), W)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    dense = attention.ring_decode_attention(tq, tk, tv, torch.from_numpy(p),
                                            W)
    with attention.use_decode_impl("auto"):
        flash = attention.ring_decode_attention(tq, tk, tv,
                                                torch.from_numpy(p), W)
    np.testing.assert_allclose(_np(dense), _np(want), **TOL)
    np.testing.assert_allclose(_np(flash), _np(want), **TOL)


# ---------------------------------------------------------------------------
# the engine end to end, on the static path
# ---------------------------------------------------------------------------


def _requests(arch):
    reqs = []
    for i in range(2):
        reqs.append(Request(f"is item {i} in stock?" + "!" * (30 * i), arch,
                            SCORE, request_id=len(reqs) + 1))
    for i, mt in enumerate([6, 2, 4]):
        reqs.append(Request(f"describe item {i} " + "w" * (20 * i), arch,
                            COMPLETE, max_tokens=mt,
                            request_id=len(reqs) + 1))
    reqs.append(Request("which colour is the sky?", arch, CLASSIFY,
                        labels=("red", "blue", "green"),
                        request_id=len(reqs) + 1))
    reqs.append(Request("embed text number 1", arch, EMBED,
                        metadata={"embed_dim": 16},
                        request_id=len(reqs) + 1))
    return reqs


def _serve(engine, reqs, tok_module, monkeypatch):
    ids = []
    real = tok_module.decode

    def record(seq):
        ids.append(tuple(int(t) for t in seq))
        return real(seq)

    monkeypatch.setattr(tok_module, "decode", record)
    out = engine.submit_batch(copy.deepcopy(reqs))
    monkeypatch.setattr(tok_module, "decode", real)
    return out, ids


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch, monkeypatch):
    """One mixed batch (SCORE, COMPLETE past the ring's wrap, CLASSIFY,
    EMBED) on both engines, both on the static path: token ids, labels,
    counts and credits equal; SCORE and EMBED within VALUE_TOL."""
    for mod in (jcfgs, tcfgs):
        monkeypatch.setattr(mod, "get_smoke_config",
                            lambda a, get=mod.get_smoke_config: _fp32(get(a)))
    kw = dict(smoke=True, max_batch=4, max_seq=64, seed=3)
    jeng = JaxInferenceEngine(arch, **kw)
    teng = TorchInferenceEngine(arch, device="cpu", **kw)
    assert teng.backend == jeng.backend == "static"
    teng.params = bridge.params_from_jax(
        teng.cfg, jax.tree.map(np.asarray, jeng.params))
    reqs = _requests(arch)
    jout, jids = _serve(jeng, reqs, jtok, monkeypatch)
    tout, tids = _serve(teng, reqs, ttok, monkeypatch)
    assert tids == jids and len(tids) == 3
    assert len(tout) == len(reqs)
    for r, j, t in zip(reqs, jout, tout):
        assert (t.request_id, t.kind, t.text, t.label, t.labels,
                t.tokens_in, t.tokens_out, t.credits) == \
            (j.request_id, j.kind, j.text, j.label, j.labels,
             j.tokens_in, j.tokens_out, j.credits), r
        if r.kind == SCORE:
            assert abs(t.score - j.score) <= VALUE_TOL
        if r.kind == EMBED:
            np.testing.assert_allclose(t.embedding, j.embedding, rtol=0,
                                       atol=VALUE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_engine_defaults_to_the_card(arch):
    """Without ``device="cpu"`` the full-size engine asks for CUDA and
    raises on a host without it; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchInferenceEngine(arch, smoke=False)
