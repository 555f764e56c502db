"""The port's model (``repro_torch.models``) and paged KV cache held to the
JAX package on params converted from a JAX ``proxy-8b`` smoke model.

Both sides are built in fp32 (``dataclasses.replace(cfg, dtype=
"float32")``) so that the check is of the algorithm, not of where bf16
rounds.  Tolerance: rtol/atol 2e-4, the fp32 tolerance of
``tests/test_kernels.py`` (the frameworks sum in different orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as tcfgs  # noqa: E402
from repro_torch.inference.paged_kv import OutOfBlocks, PagedKVCache  # noqa
from repro_torch.models import attention, lm, model_zoo  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("proxy-8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("proxy-8b"),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jzoo.build(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = model_zoo.build(tcfg)
    tparams = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(
        np.int32)


def test_configs_match_the_reference():
    for arch in ("proxy-8b", "oracle-70b"):
        assert (dataclasses.asdict(tcfgs.get_config(arch))
                == dataclasses.asdict(jcfgs.get_config(arch)))
        assert (dataclasses.asdict(tcfgs.get_smoke_config(arch))
                == dataclasses.asdict(jcfgs.get_smoke_config(arch)))
    # the last three of the zoo: the encoder-decoder, M-RoPE with patches,
    # and hd 160 (stablelm); every known id is ported
    for arch in ("whisper-base", "stablelm-12b", "qwen2-vl-7b"):
        for get in ("get_config", "get_smoke_config"):
            assert (dataclasses.asdict(getattr(tcfgs, get)(arch))
                    == dataclasses.asdict(getattr(jcfgs, get)(arch)))
    assert set(tcfgs.PORTED_IDS) == set(tcfgs.KNOWN_IDS)
    with pytest.raises(KeyError):
        tcfgs.get_config("no-such-model")
    # model_zoo.build takes M-RoPE and encoder-decoder configs, and routes
    # the encoder-decoder to models/whisper.py
    smoke = tcfgs.get_smoke_config("proxy-8b")
    mrope = model_zoo.build(dataclasses.replace(smoke,
                                                mrope_sections=(4, 2, 2)))
    assert mrope.apply.func is lm.apply
    enc_dec = model_zoo.build(tcfgs.get_smoke_config("whisper-base"))
    assert enc_dec.apply.func.__module__ == "repro_torch.models.whisper"
    assert enc_dec.logits_of.func is lm.logits_of


def test_bridge_layout_and_bf16(models):
    jm, jparams, tm, tparams = models
    cfg = tm.cfg
    assert len(tparams["layers"]) == cfg.num_layers
    for layer in range(cfg.num_layers):
        np.testing.assert_array_equal(
            _np(tparams["layers"][layer]["attn"]["wq"]),
            np.asarray(jparams["periods"]["b0"]["attn"]["wq"][layer]))
    bf = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    t = bridge.tensor_from_numpy(np.asarray(bf))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(bf.astype(jnp.float32)))


def test_train_mode_matches_jax(models):
    jm, jparams, tm, tparams = models
    toks = _tokens(0, 2, 20, tm.cfg.vocab_size)
    j = jm.apply(jparams, {"tokens": jnp.asarray(toks)}, mode="train")
    t = tm.apply(tparams, {"tokens": torch.from_numpy(toks)}, mode="train")
    np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
    jl = jm.logits_of(jparams, j["hidden"])
    tl = tm.logits_of(tparams, t["hidden"])
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_prefill_and_decode_match_jax(models):
    """Prefill of ragged rows, then two single-token decode steps (dense and
    through the flash-decode path) and one 3-token decode chunk; hidden
    states, fp32 logits and cache contents agree at every step."""
    jm, jparams, tm, tparams = models
    B, S, smax = 3, 12, 24
    toks = _tokens(1, B, S, tm.cfg.vocab_size)
    lens = np.array([12, 5, 1], np.int32)
    jc = jm.init_cache(B, smax)
    tc = tm.init_cache(B, smax)
    assert lm.cache_capacity(tc) == smax
    j = jm.apply(jparams, {"tokens": jnp.asarray(toks),
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

    def check_cache():
        np.testing.assert_array_equal(_np(tc["len"]), _np(jc["len"]))
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                _np(tc["periods"]["b0"][leaf]),
                _np(jc["periods"]["b0"][leaf]), **TOL)

    check_cache()
    from repro.models import attention as jattn
    for step, impl in enumerate(("dense", "auto")):
        nxt = _tokens(10 + step, B, 1, tm.cfg.vocab_size)
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
    # a multi-token decode chunk (the chunked-prefill shape)
    chunk = _tokens(20, B, 3, tm.cfg.vocab_size)
    j = jm.apply(jparams, {"tokens": jnp.asarray(chunk)}, mode="decode",
                 cache=jc)
    t = tm.apply(tparams, {"tokens": torch.from_numpy(chunk)},
                 mode="decode", cache=tc)
    np.testing.assert_allclose(_np(t["hidden"]), _np(j["hidden"]), **TOL)
    jc, tc = j["cache"], t["cache"]
    check_cache()


def test_chunked_write_drops_positions_past_the_end():
    ck = torch.zeros(2, 4, 1, 2)
    cv = torch.zeros(2, 4, 1, 2)
    new = torch.arange(1, 13, dtype=torch.float32).reshape(2, 3, 1, 2)
    attention.write_kv(ck, cv, new, new, torch.tensor([0, 2]))
    torch.testing.assert_close(ck[0, :3], new[0])
    torch.testing.assert_close(ck[1, 2:], new[1, :2])   # position 4 dropped
    assert (ck[1, :2] == 0).all()


# ---------------------------------------------------------------------------
# PagedKVCache: the semantics of tests/test_backend.py's allocator and
# scatter/gather round-trip tests, on the port
# ---------------------------------------------------------------------------


def test_paged_kv_allocator(models):
    kv = PagedKVCache(models[2], block_size=16, num_blocks=8)
    assert kv.max_seq_blocks == 7          # block 0 is scratch
    assert kv.free_count == 7
    assert kv.blocks_for(1) == 1 and kv.blocks_for(16) == 1
    assert kv.blocks_for(17) == 2
    got = kv.alloc(3)
    assert got == [1, 2, 3]                # LIFO free list, lowest first
    assert kv.free_count == 4
    assert kv.can_alloc(4) and not kv.can_alloc(5)
    with pytest.raises(OutOfBlocks):
        kv.alloc(5)
    kv.free_blocks(got)
    assert kv.free_count == 7
    assert kv.alloc(1) == [3]              # last freed, first reused
    with pytest.raises(ValueError):
        kv.free_blocks([1])                # double free
    with pytest.raises(ValueError):
        kv.free_blocks([0])                # scratch block is not allocable


def test_paged_kv_scatter_gather_roundtrip(models):
    tm = models[2]
    kv = PagedKVCache(tm, block_size=8, num_blocks=6)
    b0, b1 = kv.alloc(2), kv.alloc(1)
    tables = torch.tensor([[b0[0], b0[1]], [b1[0], 0]], dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    counts = torch.tensor([5, 3], dtype=torch.int32)
    dense = kv.gather(kv.pool, tables, zero)
    gen = torch.Generator().manual_seed(0)
    fake = {"periods": {"b0": {
        leaf: torch.randn(x.shape, generator=gen).to(x.dtype)
        for leaf, x in dense["periods"]["b0"].items()}}}
    pool2 = kv.scatter(kv.pool, fake, tables, zero, counts, 8)
    assert pool2 is kv.pool                # updated in place
    got = kv.gather(pool2, tables, counts)
    assert got["len"] is counts
    for leaf in ("k", "v"):
        g = got["periods"]["b0"][leaf]     # [P, B, S, KV, hd]
        f = fake["periods"]["b0"][leaf]
        for row, cnt in enumerate(counts.tolist()):
            # written prefix persisted exactly; tails and the scratch
            # block stayed zero
            assert torch.equal(g[:, row, :cnt], f[:, row, :cnt])
            assert (g[:, row, cnt:] == 0).all()
    # a write window that starts mid-table lands in the right blocks
    start = torch.tensor([5, 3], dtype=torch.int32)
    kv.scatter(kv.pool, fake, tables, start, torch.tensor([6, 0]), 8)
    got = kv.gather(kv.pool, tables, start)
    k = got["periods"]["b0"]["k"]
    fk = fake["periods"]["b0"]["k"]
    assert torch.equal(k[:, 0, 5:11], fk[:, 0, 5:11])
    assert (k[:, 1, 3:] == 0).all()
