"""The port's zoo decoders with qk-norm, parallel blocks and mixtures of
experts (qwen3-32b, command-r-35b, minitron-8b, phi3.5-moe-42b-a6.6b,
qwen2-moe-a2.7b, stablelm-12b) held to the JAX package on params converted
from JAX smoke models.

Configs, param trees, the whole LM in train, prefill and decode mode, the
MoE load-balance loss and the engine on both backends are compared on the
same numpy inputs, and the MoE routing and capacity functions alone.
Both sides are built in fp32 (``dataclasses.replace(cfg, dtype=
"float32")``), so the check is of the algorithm, not of where bf16
rounds.  Tolerances: logits and hidden states rtol/atol 2e-4, that of
``tests/test_torch_model.py`` (the frameworks sum in different orders:
the port adds each token's expert outputs as a sum over expert planes,
JAX as a scatter-add); the aux loss within 1e-6; the engine's SCORE and
EMBED values within 1e-5 and its token ids, labels, texts, counts and
credits equal.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
import repro_torch.configs.base as tcfgs  # noqa: E402
import repro_torch.inference.tokenizer as ttok  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.inference import continuous  # noqa: E402
from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED,  # noqa
                                           SCORE, Request)
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from repro_torch.models import attention, blocks, lm, model_zoo  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
AUX_TOL = 1e-6
VALUE_TOL = 1e-5
ARCHS = ("qwen3-32b", "command-r-35b", "minitron-8b", "phi3.5-moe-42b-a6.6b",
         "qwen2-moe-a2.7b", "stablelm-12b")
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b")
BIASES = ("bq", "bk", "bv", "bo", "bi", "bg", "bias")


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _nonzero_norms(tree, seed):
    """The JAX tree with every bias leaf (stablelm-12b's LayerNorm biases)
    drawn from N(0, 0.1^2) and every norm's scale from N(1, 0.1^2),
    seeded: JAX's init makes biases zero and scales one, and a port that
    dropped or misplaced one of them would agree with it there."""
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


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = _fp32(jcfgs.get_smoke_config(arch))
    tcfg = _fp32(tcfgs.get_smoke_config(arch))
    jm = jzoo.build(jcfg)
    jparams = _nonzero_norms(jax.jit(jm.init_params)(jax.random.PRNGKey(0)),
                             11)
    tm = model_zoo.build(tcfg)
    tparams = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    japply = jax.jit(jm.apply, static_argnames=("mode", "remat"))
    return jm, jparams, japply, tm, tparams


# ---------------------------------------------------------------------------
# configs and param trees
# ---------------------------------------------------------------------------


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
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """The port's own init (bf16, the served dtype) has the JAX tree's
    leaves, shapes and dtypes once the period stacks are split into
    layers: q_norm / k_norm of [head_dim], the fp32 router over the padded
    experts, the stacked experts, the fused shared expert, ln2 in a
    parallel block, no lm_head with tied embeddings."""
    cfg = tcfgs.get_smoke_config(arch)
    jshape = jax.eval_shape(jzoo.build(jcfgs.get_smoke_config(arch))
                            .init_params, jax.random.PRNGKey(0))
    tp = model_zoo.build(cfg).init_params(torch.Generator().manual_seed(0))
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    assert len(tp["layers"]) == cfg.num_layers
    want = {k: (s[1:], d) for k, (s, d) in
            _leaf_specs(jshape["periods"]["b0"]).items()}
    for lp in tp["layers"]:
        assert _leaf_specs(lp) == want
    top = {k: v for k, v in tp.items() if k != "layers"}
    assert _leaf_specs(top) == _leaf_specs(
        {k: v for k, v in jshape.items() if k != "periods"})
    lp = tp["layers"][0]
    assert ("q_norm" in lp["attn"]) == cfg.qk_norm
    assert "ln2" in lp
    if cfg.moe is not None:
        E = cfg.moe.padded_num_experts
        assert lp["moe"]["router"]["w"].dtype == torch.float32
        assert lp["moe"]["experts"]["wi"].shape == (E, cfg.d_model,
                                                     cfg.moe.expert_d_ff)
        # every expert of the stack drawn on its own
        wi = lp["moe"]["experts"]["wi"].float()
        assert not torch.equal(wi[0], wi[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_qkv_at_full_heads_matches_jax(arch):
    """q, k, v of the full config's heads (hd 128, 160 for stablelm; the
    config's qk-norm and RoPE theta: 1e6 for qwen3 and qwen2-moe, 8e6 for
    command-r) on a narrow d_model, at positions up to 8191: the port's
    RoPE tables and per-head RMSNorm equal JAX's within 2e-4 (fp32)."""
    full = jcfgs.get_config(arch)
    jcfg = dataclasses.replace(full, d_model=32, dtype="float32")
    tcfg = _fp32(dataclasses.replace(tcfgs.get_config(arch), d_model=32))
    jp = jblocks.attn_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    if jcfg.qk_norm:     # non-trivial scales, so the norm's weight counts
        for name in ("q_norm", "k_norm"):
            jp[name]["scale"] = jnp.linspace(0.5, 1.5, jcfg.head_dim)
    tp = jax.tree.map(lambda a: bridge.tensor_from_numpy(np.asarray(a)), jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    pos = np.sort(rng.integers(0, 8192, (2, 5)), axis=1).astype(np.int32)
    j = jblocks._qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    t = blocks._qkv(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    assert tcfg.head_dim == (160 if arch == "stablelm-12b" else 128)
    assert tcfg.rope_theta == full.rope_theta
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


# ---------------------------------------------------------------------------
# the whole LM: train, prefill, decode, and the aux loss
# ---------------------------------------------------------------------------


def _check_aux(cfg, t, j):
    if cfg.moe is None:
        assert float(t["aux"]) == 0.0 == float(j["aux"])
    else:
        assert float(j["aux"]) > 0.0
        assert abs(float(t["aux"]) - float(j["aux"])) <= AUX_TOL


def test_train_mode_matches_jax(models):
    """Train mode over 2 x 37 tokens: hidden states, fp32 logits and the
    aux loss; MoE layers run with capacity ceil(k * 74 * 1.25 / E), so
    tokens overflow and drop on both sides."""
    jm, jparams, japply, tm, tparams = models
    toks = _tokens(2, 2, 37, tm.cfg.vocab_size)
    j = japply(jparams, {"tokens": jnp.asarray(toks)}, mode="train",
               remat=False)
    t = tm.apply(tparams, {"tokens": torch.from_numpy(toks)}, mode="train")
    np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
    np.testing.assert_allclose(_np(tm.logits_of(tparams, t["hidden"])),
                               _np(jm.logits_of(jparams, j["hidden"])),
                               **TOL)
    _check_aux(tm.cfg, t, j)


def test_prefill_and_decode_match_jax(models):
    """Ragged prefill (capacity-bound MoE), then single-token decode steps
    on the dense einsum and the flash-decode path (K1's plain version on
    the CPU), then a 3-token decode chunk (the chunked-prefill shape;
    dropless); last hidden states, fp32 logits, the aux loss and every
    cache leaf agree at every step."""
    jm, jparams, japply, tm, tparams = models
    cfg = tm.cfg
    B, S, smax = 3, 12, 24
    toks = _tokens(1, B, S, cfg.vocab_size)
    lens = np.array([12, 5, 1], np.int32)
    j = japply(jparams, {"tokens": jnp.asarray(toks),
                         "lengths": jnp.asarray(lens)},
               mode="prefill", cache=jm.init_cache(B, smax))
    t = tm.apply(tparams, {"tokens": torch.from_numpy(toks),
                           "lengths": torch.from_numpy(lens)},
                 mode="prefill", cache=tm.init_cache(B, smax))
    np.testing.assert_allclose(_np(t["last_hidden"]), _np(j["last_hidden"]),
                               **TOL)
    np.testing.assert_allclose(_np(tm.logits_of(tparams, t["last_hidden"])),
                               _np(jm.logits_of(jparams, j["last_hidden"])),
                               **TOL)
    _check_aux(cfg, t, j)
    jc, tc = j["cache"], t["cache"]

    def check_cache():
        np.testing.assert_array_equal(_np(tc["len"]), _np(jc["len"]))
        for leaf in ("k", "v"):
            np.testing.assert_allclose(_np(tc["periods"]["b0"][leaf]),
                                       _np(jc["periods"]["b0"][leaf]), **TOL)

    check_cache()
    for step, impl in enumerate(("dense", "auto")):
        nxt = _tokens(10 + step, B, 1, cfg.vocab_size)
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
        _check_aux(cfg, t, j)
        jc, tc = j["cache"], t["cache"]
        check_cache()
    chunk = _tokens(20, B, 3, cfg.vocab_size)
    j = japply(jparams, {"tokens": jnp.asarray(chunk)}, mode="decode",
               cache=jc)
    t = tm.apply(tparams, {"tokens": torch.from_numpy(chunk)},
                 mode="decode", cache=tc)
    np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
    _check_aux(cfg, t, j)
    jc, tc = j["cache"], t["cache"]
    check_cache()


# ---------------------------------------------------------------------------
# MoE units against the JAX functions
# ---------------------------------------------------------------------------


def _moe_cfg(arch):
    return _fp32(tcfgs.get_smoke_config(arch)).moe


def test_route_masks_padding_experts_and_breaks_ties_low():
    """qwen2-moe's smoke router: 6 true experts padded to 8.  Two router
    columns are equal, so every token ties between experts 1 and 4; the
    gates keep the lower index as ``jax.lax.top_k`` does, no token goes to
    a padding expert, and gates and aux equal JAX's."""
    m = _moe_cfg("qwen2-moe-a2.7b")
    assert m.padded_num_experts > m.num_experts
    rng = np.random.default_rng(7)
    D, T = 16, 40
    w = rng.standard_normal((D, m.padded_num_experts)).astype(np.float32)
    w[:, 4] = w[:, 1]
    w[:, m.num_experts:] *= 10.0        # masked all the same
    x = rng.standard_normal((T, D)).astype(np.float32)
    jg, jaux = jblocks._route(jnp.asarray(w), jnp.asarray(x), m)
    tg, taux = blocks._route(torch.from_numpy(w), torch.from_numpy(x), m)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(tg) > 0, _np(jg) > 0)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    assert (_np(tg)[:, m.num_experts:] == 0).all()
    assert ((_np(tg) > 0).sum(1) == m.num_experts_per_tok).all()
    np.testing.assert_allclose(_np(tg).sum(1), 1.0, rtol=1e-6)
    # tokens whose top-k boundary falls between the tied experts keep 1
    one = (_np(tg)[:, 1] > 0) != (_np(tg)[:, 4] > 0)
    assert one.any() and (_np(tg)[one, 1] > 0).all()


def test_moe_local_drops_the_same_token_under_overflow():
    """Capacity 2 on an expert that 4 tokens choose, two of them identical
    rows with equal gates: the higher-priority token and the lower index
    of the tied pair are kept, the later twin drops, as in JAX."""
    rng = np.random.default_rng(8)
    T, D, F, E = 6, 8, 12, 3
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[4] = x[1]                                   # identical token rows
    gates = np.zeros((T, E), np.float32)
    gates[[0, 1, 3, 4], 0] = [0.3, 0.6, 0.9, 0.6]  # expert 0: 4 tokens
    gates[[0, 2, 3, 5], 1] = [0.7, 1.0, 0.1, 1.0]
    gates[[2], 2] = [0.5]
    wi, wg = (rng.standard_normal((E, D, F)).astype(np.float32)
              for _ in range(2))
    wo = rng.standard_normal((E, F, D)).astype(np.float32)
    j = jblocks._moe_local(*(jnp.asarray(a) for a in (x, gates, wi, wg, wo)),
                           2)
    t = blocks._moe_local(*(torch.from_numpy(a) for a in
                            (x, gates, wi, wg, wo)), 2)
    np.testing.assert_allclose(_np(t), _np(j), **TOL)
    assert np.abs(_np(t)[1]).max() > 0            # twin 1 kept
    assert (_np(t)[4] == 0).all() and (_np(j)[4] == 0).all()  # twin 4 dropped
    # without the overflow every chosen token is computed
    t_all = blocks._moe_local(*(torch.from_numpy(a) for a in
                                (x, gates, wi, wg, wo)), T)
    assert np.abs(_np(t_all)[4]).max() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_apply_matches_jax(arch, mode):
    """One MoE layer alone on [3, 11] tokens with two identical rows:
    output and aux equal JAX's in each mode (capacity-bound in train and
    prefill, dropless in decode)."""
    cfg = _fp32(tcfgs.get_smoke_config(arch))
    jcfg = _fp32(jcfgs.get_smoke_config(arch))
    jp = jblocks.moe_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: bridge.tensor_from_numpy(np.asarray(a)), jp)
    x = np.random.default_rng(9).standard_normal(
        (3, 11, cfg.d_model)).astype(np.float32)
    x[2] = x[0]
    jy, jaux = jblocks.moe_apply(jp, jnp.asarray(x),
                                 jblocks.Ctx(cfg=jcfg, mode=mode,
                                             positions=None))
    ty, taux = blocks.moe_apply(tp, torch.from_numpy(x),
                                blocks.Ctx(cfg=cfg, mode=mode,
                                           positions=None))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    cap = blocks._capacity(cfg.moe, 33, mode)
    assert cap == jblocks._capacity(jcfg.moe, 33, mode)
    assert (cap == 33) == (mode == "decode")


# ---------------------------------------------------------------------------
# the engine end to end, on both backends
# ---------------------------------------------------------------------------


def _requests(arch):
    reqs = []
    for i in range(3):
        reqs.append(Request(f"is item {i} in stock?" + "!" * (9 * i), arch,
                            SCORE, request_id=len(reqs) + 1))
    for i, mt in enumerate([7, 2, 5, 3]):
        reqs.append(Request(f"describe item {i} " + "w" * (5 * i), arch,
                            COMPLETE, max_tokens=mt,
                            request_id=len(reqs) + 1))
    reqs.append(Request("which colour is the sky?", arch, CLASSIFY,
                        labels=("red", "blue", "green"),
                        request_id=len(reqs) + 1))
    reqs.append(Request("pick any", arch, CLASSIFY, labels=("yes", "no"),
                        multi_label=True, request_id=len(reqs) + 1))
    for i, dim in enumerate([16, 32]):
        reqs.append(Request(f"embed text number {i}", arch, EMBED,
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
    out = engine.submit_batch(copy.deepcopy(reqs))
    monkeypatch.setattr(tok_module, "decode", real)
    return out, ids


@pytest.mark.parametrize("backend", ["continuous", "static"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch, backend, monkeypatch):
    """One mixed batch on both engines: token ids, texts, labels, counts
    and credits equal; SCORE and EMBED within VALUE_TOL.  CLASSIFY's
    label rows share their prompt, so under a capacity-bound MoE the
    tokens of one row compete with identical tokens of its twins."""
    for mod in (jcfgs, tcfgs):
        monkeypatch.setattr(mod, "get_smoke_config",
                            lambda a, get=mod.get_smoke_config: _fp32(get(a)))
    kw = dict(smoke=True, max_batch=4, max_seq=64, seed=3, backend=backend)
    jeng = JaxInferenceEngine(arch, **kw)
    teng = TorchInferenceEngine(arch, device="cpu", **kw)
    assert teng.backend == jeng.backend == backend
    assert continuous.supports(teng.cfg)
    jeng.params = _nonzero_norms(jeng.params, 14)
    teng.params = bridge.params_from_jax(
        teng.cfg, jax.tree.map(np.asarray, jeng.params))
    reqs = _requests(arch)
    jout, jids = _serve(jeng, reqs, jtok, monkeypatch)
    tout, tids = _serve(teng, reqs, ttok, monkeypatch)
    assert tids == jids and len(tids) == 4
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


def test_paged_pool_holds_every_layer():
    """The continuous batcher's pool for the full qwen3-32b (on the meta
    device, nothing allocated): one [blocks, block_size, 8, 128] plane of
    K and of V for each of its 64 layers, 256 KiB of bf16 a token."""
    from repro_torch.inference.paged_kv import PagedKVCache
    model = model_zoo.build("qwen3-32b")
    kv = PagedKVCache(model, block_size=32, num_blocks=129, device="meta")
    k = kv.pool["periods"]["b0"]["k"]
    assert k.shape == (64, 129, 32, 8, 128) and k.dtype == torch.bfloat16
    per_token = sum(t.element_size() * t[:, 0, 0].numel()
                    for t in kv.pool["periods"]["b0"].values())
    assert per_token == 64 * 2 * 8 * 128 * 2
