"""The port's whisper-base (encoder-decoder over audio frames) and
qwen2-vl-7b (patches before the text, M-RoPE) held to the JAX package on
params converted from JAX smoke models.

Configs, param trees, M-RoPE alone, whisper's encoder, both models in
train, prefill and decode mode (whisper's cross-attention cache too) and
the engine are compared on the same numpy inputs.  Both sides are built in
fp32 (``dataclasses.replace(cfg, dtype="float32")``), so the check is of
the algorithm, not of where bf16 rounds.  Tolerances: hidden states and
logits rtol/atol 2e-4, that of ``tests/test_torch_model.py`` (the
frameworks sum in different orders); the engine's SCORE and EMBED values
within 1e-5 and its token ids, texts, labels, counts and credits equal.
The JAX engine cannot serve qwen2-vl's SCORE (its cache is sized for the
text, not the P patches before it) or CLASSIFY (its label pass builds no
patches); the port raises as it does, with the same exception class.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as jcfgs  # noqa: E402
import repro.inference.tokenizer as jtok  # noqa: E402
from repro.inference.engine import JaxInferenceEngine  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
import repro_torch.configs.base as tcfgs  # noqa: E402
import repro_torch.inference.tokenizer as ttok  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.inference import continuous  # noqa: E402
from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED,  # noqa
                                           SCORE, Request)
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention, common, model_zoo  # noqa: E402
from repro_torch.models import whisper  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
VALUE_TOL = 1e-5
ARCHS = ("whisper-base", "qwen2-vl-7b")
BIASES = ("bq", "bk", "bv", "bo", "bi", "bg", "bias")


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _nonzero_biases(tree, seed):
    """The JAX tree with every bias leaf drawn from N(0, 0.1^2) and every
    norm's scale from N(1, 0.1^2), seeded: JAX's init makes biases zero
    and scales one, and a port that dropped or misplaced one of them would
    agree with it there."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in BIASES:
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.standard_normal(a.shape),
                               a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = _fp32(jcfgs.get_smoke_config(arch))
    tcfg = _fp32(tcfgs.get_smoke_config(arch))
    jm = jzoo.build(jcfg)
    jparams = _nonzero_biases(jax.jit(jm.init_params)(jax.random.PRNGKey(0)),
                              11)
    tm = model_zoo.build(tcfg)
    tparams = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    japply = jax.jit(jm.apply, static_argnames=("mode", "remat"))
    return jm, jparams, japply, tm, tparams


def _batch(cfg, seed, B, S, *, positions=False):
    """tokens [B,S] and the front end's inputs, as (jax dict, torch dict):
    frames [B, encoder_seq, D] or patches [B, 16, D], with M-RoPE
    positions [B, 16 + S, 3] whose three streams differ where asked."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend == "frames":
        arrs["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        P = min(cfg.num_patches, 16)
        arrs["patches"] = rng.standard_normal((B, P, cfg.d_model)).astype(
            np.float32)
        if positions:
            arrs["positions"] = rng.integers(0, 300, (B, P + S, 3)).astype(
                np.int32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


# ---------------------------------------------------------------------------
# configs, param trees, M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tcfgs, get)(arch))
                == dataclasses.asdict(getattr(jcfgs, get)(arch)))
    assert arch in tcfgs.PORTED_IDS
    cfg = tcfgs.get_config(arch)
    model = model_zoo.build(arch)                  # full size builds too
    assert model.cfg == cfg
    assert (model.apply.func is whisper.apply) == cfg.is_encoder_decoder
    assert not continuous.supports(cfg)            # the static path


def test_every_config_of_the_zoo_builds():
    assert set(tcfgs.PORTED_IDS) == set(tcfgs.KNOWN_IDS)
    for arch in tcfgs.KNOWN_IDS:
        for smoke in (False, True):
            model = model_zoo.build(arch, smoke=smoke)
            assert model.cfg == (tcfgs.get_smoke_config(arch) if smoke
                                 else tcfgs.get_config(arch))


def _leaf_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_specs(v, f"{prefix}{k}/"))
        elif isinstance(v, list):
            for i, x in enumerate(v):
                out.update(_leaf_specs(x, f"{prefix}{k}/{i}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def _unstacked(tree, prefix=""):
    """The JAX tree's leaf specs with its stacked layers split: whisper's
    ``enc_layers`` / ``dec_layers`` [L, ...] and the decoder's period
    stacks [P, ...] (each period position is then the port's layer list)."""
    out = {}
    for k, v in tree.items():
        if k in ("enc_layers", "dec_layers", "b0"):
            n = jax.tree.leaves(v)[0].shape[0]
            name = "layers" if k == "b0" else k
            for i in range(n):
                sub = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                    a.shape[1:], a.dtype), v)
                out.update(_unstacked(sub, f"{name}/{i}/"))
        elif isinstance(v, dict):
            out.update(_unstacked(v, f"{prefix}{k}/" if k != "periods"
                                  else prefix))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """The port's own init (bf16, the served dtype) has the JAX tree's
    leaves, shapes and dtypes once the stacks are split into layers:
    whisper's encoder and decoder layers with biases on every projection
    (``bq``, ``bk``, ``bv``, ``bo``; ``bi``, ``bg``, ``bo`` in the MLP),
    LayerNorms, learned positions and no ``lm_head``; qwen2-vl's plain
    decoder layers."""
    cfg = tcfgs.get_smoke_config(arch)
    jshape = jax.eval_shape(jzoo.build(jcfgs.get_smoke_config(arch))
                            .init_params, jax.random.PRNGKey(0))
    tp = model_zoo.build(cfg).init_params(torch.Generator().manual_seed(0))
    assert _leaf_specs(tp) == _unstacked(jshape)
    if cfg.is_encoder_decoder:
        assert "lm_head" not in tp
        lp = tp["dec_layers"][0]
        assert set(lp) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
        assert {"bq", "bk", "bv", "bo"} <= set(lp["xattn"])
        assert {"bi", "bg", "bo"} <= set(lp["mlp"])
        assert "bias" in lp["ln1"]


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16), ((16, 24, 24), 128)])
def test_mrope_matches_jax(sections, hd):
    """M-RoPE on x [B, S, H, hd] with positions [B, S, 3] whose streams
    differ (qwen2-vl's sections at the smoke and the full head dim), and
    with equal streams, where it is plain RoPE at the same positions."""
    rng = np.random.default_rng(3)
    B, S, H = 2, 7, 3
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 5000, (B, S, 3)).astype(np.int32)
    j = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    t = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                          sections)
    np.testing.assert_allclose(_np(t), _np(j), **TOL)
    same = np.repeat(pos[..., :1], 3, axis=-1)
    t3 = common.apply_rope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                           sections)
    t1 = common.apply_rope(torch.from_numpy(x),
                           torch.from_numpy(same[..., 0]), 1e6)
    torch.testing.assert_close(t3, t1, rtol=0, atol=0)
    with pytest.raises(ValueError):
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                          (4, 2, 1))


# ---------------------------------------------------------------------------
# the models: train, prefill, decode
# ---------------------------------------------------------------------------


def test_whisper_encoder_matches_jax():
    jcfg = _fp32(jcfgs.get_smoke_config("whisper-base"))
    tcfg = _fp32(tcfgs.get_smoke_config("whisper-base"))
    jp = _nonzero_biases(jax.jit(jwhisper.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1)), 12)
    tp = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    (jb, tb) = _batch(tcfg, 4, 3, 5)
    j = jwhisper.encode(jcfg, jp, jb["frames"])
    t = whisper.encode(tcfg, tp, tb["frames"])
    assert t.shape == (3, tcfg.encoder_seq, tcfg.d_model)
    np.testing.assert_allclose(_np(t), _np(j), **TOL)


def test_train_mode_matches_jax(models):
    """Train mode: hidden states [B, S (+ P), D] and fp32 logits; qwen2-vl
    with caller-given M-RoPE positions [B, P + S, 3] and without."""
    jm, jparams, japply, tm, tparams = models
    for given in (False, True):
        jb, tb = _batch(tm.cfg, 5, 2, 13, positions=given)
        j = japply(jparams, jb, mode="train", remat=False)
        t = tm.apply(tparams, tb, mode="train")
        np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]),
                                   **TOL)
        np.testing.assert_allclose(
            _np(tm.logits_of(tparams, t["hidden"])),
            _np(jm.logits_of(jparams, j["hidden"])), **TOL)
        assert float(t["aux"]) == 0.0 == float(j["aux"])


def test_prefill_and_decode_match_jax(models):
    """Ragged prefill, then single-token decode steps on the dense einsum
    and the flash-decode path (K1's plain version on the CPU), then a
    3-token decode chunk: last hidden states, fp32 logits and every cache
    leaf agree at every step (whisper's cross-attention ``xk`` / ``xv``
    among them).  qwen2-vl's prefill takes given [B, P + S, 3] positions;
    its decode steps their default, as the engine runs them."""
    jm, jparams, japply, tm, tparams = models
    cfg = tm.cfg
    B, S, smax = 3, 12, 40
    jb, tb = _batch(cfg, 6, B, S, positions=True)
    lens = np.array([12, 5, 1], np.int32)
    jb["lengths"], tb["lengths"] = jnp.asarray(lens), torch.from_numpy(lens)
    j = japply(jparams, jb, mode="prefill", cache=jm.init_cache(B, smax))
    t = tm.apply(tparams, tb, mode="prefill", cache=tm.init_cache(B, smax))
    np.testing.assert_allclose(_np(t["last_hidden"]), _np(j["last_hidden"]),
                               **TOL)
    np.testing.assert_allclose(_np(tm.logits_of(tparams, t["last_hidden"])),
                               _np(jm.logits_of(jparams, j["last_hidden"])),
                               **TOL)
    jc, tc = j["cache"], t["cache"]

    def leaves(c):
        if cfg.is_encoder_decoder:
            return {k: c[k] for k in ("k", "v", "xk", "xv")}
        return c["periods"]["b0"]

    def check_cache():
        np.testing.assert_array_equal(_np(tc["len"]), _np(jc["len"]))
        jl, tl = leaves(jc), leaves(tc)
        assert set(jl) == set(tl)
        for leaf in jl:
            np.testing.assert_allclose(_np(tl[leaf]), _np(jl[leaf]), **TOL)

    check_cache()
    if cfg.is_encoder_decoder:    # the encoder's K/V, every layer and row
        assert np.abs(_np(tc["xk"])).sum(axis=(2, 3, 4)).min() > 0
    for step, impl in enumerate(("dense", "auto")):
        nxt = np.random.default_rng(10 + step).integers(
            4, cfg.vocab_size, (B, 1)).astype(np.int32)
        from repro.models import attention as jattn
        with jattn.use_decode_impl(impl):
            j = jm.apply(jparams, {"tokens": jnp.asarray(nxt)},
                         mode="decode", cache=jc)
        with attention.use_decode_impl(impl):
            t = tm.apply(tparams, {"tokens": torch.from_numpy(nxt)},
                         mode="decode", cache=tc)
        np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
        np.testing.assert_allclose(
            _np(tm.logits_of(tparams, t["hidden"][:, 0])),
            _np(jm.logits_of(jparams, j["hidden"][:, 0])), **TOL)
        jc, tc = j["cache"], t["cache"]
        check_cache()
    chunk = np.random.default_rng(20).integers(
        4, cfg.vocab_size, (B, 3)).astype(np.int32)
    j = japply(jparams, {"tokens": jnp.asarray(chunk)}, mode="decode",
               cache=jc)
    t = tm.apply(tparams, {"tokens": torch.from_numpy(chunk)}, mode="decode",
                 cache=tc)
    np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
    jc, tc = j["cache"], t["cache"]
    check_cache()


def test_learned_positions_match_jax():
    """A decoder with learned positions (``pos_embed``, read at the given
    positions' first stream): proxy-8b's smoke config with them on, in
    train and prefill mode, on converted params."""
    over = dict(learned_pos_embed=True, max_pos_embed=64, use_rope=False)
    jcfg = dataclasses.replace(_fp32(jcfgs.get_smoke_config("proxy-8b")),
                               **over)
    tcfg = dataclasses.replace(_fp32(tcfgs.get_smoke_config("proxy-8b")),
                               **over)
    jm, tm = jzoo.build(jcfg), model_zoo.build(tcfg)
    jp = _nonzero_biases(jm.init_params(jax.random.PRNGKey(2)), 13)
    tp = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    assert tp["pos_embed"]["w"].shape == (64, tcfg.d_model)
    rng = np.random.default_rng(9)
    toks = rng.integers(4, tcfg.vocab_size, (2, 9)).astype(np.int32)
    pos = rng.integers(0, 64, (2, 9)).astype(np.int32)
    j = jm.apply(jp, {"tokens": jnp.asarray(toks),
                      "positions": jnp.asarray(pos)}, mode="train")
    t = tm.apply(tp, {"tokens": torch.from_numpy(toks),
                      "positions": torch.from_numpy(pos)}, mode="train")
    np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
    lens = np.array([9, 4], np.int32)
    j = jm.apply(jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(
        lens), "positions": jnp.asarray(pos)}, mode="prefill",
        cache=jm.init_cache(2, 16))
    t = tm.apply(tp, {"tokens": torch.from_numpy(toks),
                      "lengths": torch.from_numpy(lens),
                      "positions": torch.from_numpy(pos)}, mode="prefill",
                 cache=tm.init_cache(2, 16))
    np.testing.assert_allclose(_np(t["last_hidden"]), _np(j["last_hidden"]),
                               **TOL)


def test_prefill_longer_than_its_cache_raises_as_jax_does(models):
    """A pass longer than the cache (qwen2-vl: P patches + S tokens into
    S rows) raises TypeError on both sides; whisper's text fits."""
    jm, jparams, japply, tm, tparams = models
    B, S = 2, 8
    jb, tb = _batch(tm.cfg, 7, B, S)
    if tm.cfg.frontend != "patches":
        tm.apply(tparams, tb, mode="prefill", cache=tm.init_cache(B, S))
        return
    with pytest.raises(TypeError):
        jm.apply(jparams, jb, mode="prefill", cache=jm.init_cache(B, S))
    with pytest.raises(TypeError):
        tm.apply(tparams, tb, mode="prefill", cache=tm.init_cache(B, S))


def test_whisper_attention_routes(monkeypatch):
    """Which attention each of whisper's passes takes, recorded at the
    kernels' model-layout wrappers (their plain versions on the CPU, with
    the full-sequence attention routed to the flash wrapper as on the
    card): a prefill runs the encoder's self-attention and every
    cross-attention as non-causal flash attention (K2 with causal=0) and
    the decoder's self-attention as causal flash attention; a decode step
    the decoder's self-attention as flash-decode (K1) and the
    cross-attention as non-causal flash attention of one query over the
    encoder's keys."""
    cfg = _fp32(tcfgs.get_smoke_config("whisper-base"))
    model = model_zoo.build(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    calls = []
    real_flash, real_dec = flash_ops.flash_attention, dec_ops.flash_decode

    def flash(q, k, v, **kw):
        calls.append(("flash", q.shape[1], k.shape[1], kw.get("causal")))
        return real_flash(q, k, v, **kw)

    def dec(q, kc, vc, lengths, **kw):
        calls.append(("decode", q.shape[1], kc.shape[1], None))
        return real_dec(q, kc, vc, lengths, **kw)

    def routed(q, k, v, *, window=0, chunk=1024, causal=True):
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)

    monkeypatch.setattr(flash_ops, "flash_attention", flash)
    monkeypatch.setattr(dec_ops, "flash_decode", dec)
    monkeypatch.setattr(attention, "causal_attention", routed)
    _, tb = _batch(cfg, 8, 2, 5)
    cache = model.init_cache(2, 16)
    with attention.use_decode_impl("auto"):
        model.apply(params, tb, mode="prefill", cache=cache)
        n_pass = len(calls)
        model.apply(params, {"tokens": tb["tokens"][:, :1]}, mode="decode",
                    cache=cache)
    L, E, Se = cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq
    assert calls[:n_pass] == ([("flash", Se, Se, False)] * E
                              + [("flash", 5, 5, True),
                                 ("flash", 5, Se, False)] * L)
    assert calls[n_pass:] == [("decode", 1, 16, None),
                              ("flash", 1, Se, False)] * L


# ---------------------------------------------------------------------------
# the engine end to end (the static path)
# ---------------------------------------------------------------------------


def _requests(arch, kinds):
    reqs = []
    if SCORE in kinds:
        for i in range(3):
            reqs.append(Request(f"is clip {i} speech?" + "!" * (9 * i), arch,
                                SCORE, request_id=len(reqs) + 1))
    if COMPLETE in kinds:
        for i, mt in enumerate([7, 2, 5]):
            reqs.append(Request(f"transcribe item {i} " + "w" * (5 * i),
                                arch, COMPLETE, max_tokens=mt,
                                metadata={"file": f"s3://media/{i}.bin"}
                                if i == 1 else {},
                                request_id=len(reqs) + 1))
    if CLASSIFY in kinds:
        reqs.append(Request("which instrument plays?", arch, CLASSIFY,
                            labels=("piano", "violin", "drums"),
                            request_id=len(reqs) + 1))
        reqs.append(Request("pick any", arch, CLASSIFY, labels=("yes", "no"),
                            multi_label=True, request_id=len(reqs) + 1))
    if EMBED in kinds:
        for i, dim in enumerate([16, 32]):
            reqs.append(Request(f"embed clip number {i}", arch, EMBED,
                                metadata={"embed_dim": dim},
                                request_id=len(reqs) + 1))
    return reqs


def _serve(engine, reqs, tok_module, monkeypatch):
    ids = []
    real = tok_module.decode

    def record(seq):
        ids.append(tuple(int(t) for t in seq))
        return real(seq)

    monkeypatch.setattr(tok_module, "decode", record)
    try:
        out = engine.submit_batch(copy.deepcopy(reqs))
    finally:
        monkeypatch.setattr(tok_module, "decode", real)
    return out, ids


@pytest.fixture
def engines(monkeypatch):
    def make(arch):
        for mod in (jcfgs, tcfgs):
            monkeypatch.setattr(
                mod, "get_smoke_config",
                lambda a, get=mod.get_smoke_config: _fp32(get(a)))
        kw = dict(smoke=True, max_batch=4, max_seq=64, seed=3)
        jeng = JaxInferenceEngine(arch, **kw)
        teng = TorchInferenceEngine(arch, device="cpu", **kw)
        assert teng.backend == jeng.backend == "static"
        jeng.params = _nonzero_biases(jeng.params, 14)
        teng.params = bridge.params_from_jax(
            teng.cfg, jax.tree.map(np.asarray, jeng.params))
        return jeng, teng
    return make


SERVED = {"whisper-base": (SCORE, COMPLETE, CLASSIFY, EMBED),
          "qwen2-vl-7b": (COMPLETE, EMBED)}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch, engines, monkeypatch):
    """One mixed batch of every kind the JAX engine serves for the model
    on both engines: token ids, texts, labels, counts and credits equal;
    SCORE and EMBED within VALUE_TOL."""
    jeng, teng = engines(arch)
    reqs = _requests(arch, SERVED[arch])
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


@pytest.mark.parametrize("kind,exc", [(SCORE, TypeError),
                                      (CLASSIFY, KeyError)])
def test_qwen2_vl_score_and_classify_raise_as_jax_does(kind, exc, engines):
    """The JAX engine's gap, reproduced: SCORE prefills P + S positions
    into a cache of S rows (TypeError), CLASSIFY's label pass has no
    patches (KeyError 'patches')."""
    jeng, teng = engines("qwen2-vl-7b")
    reqs = _requests("qwen2-vl-7b", (kind,))
    with pytest.raises(exc) as j_err:
        jeng.submit_batch(copy.deepcopy(reqs))
    with pytest.raises(exc) as t_err:
        teng.submit_batch(copy.deepcopy(reqs))
    if exc is KeyError:
        assert j_err.value.args == t_err.value.args == ("patches",)
