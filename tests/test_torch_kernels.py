"""The port's attention kernels.

On the CPU: the plain PyTorch versions of flash-decode (K1) and flash
attention (K2) held to the JAX package's ``ref.py`` and to its Pallas
kernels run in interpret mode, on the same numpy inputs.  Tolerances are
those of ``tests/test_kernels.py``: fp32 2e-4, bf16 5e-2.  The CUDA
kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import \
    decode_attention_kernel  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_dec_ref,
    decode_attention_with_lse_ref as j_dec_lse_ref)
from repro.kernels.flash_attention.kernel import \
    flash_attention_kernel  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as j_flash_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, decode_attention_with_lse_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """numpy normals rounded to ``dtype``, as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    js = [jnp.asarray(a).astype(JD[dtype]) for a in arrs]
    ts = [torch.from_numpy(a).to(TD[dtype]) for a in arrs]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# K1: flash-decode, plain version vs JAX ref and Pallas (interpret)
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # B, Smax, H, KV, hd, lengths
    (3, 100, 8, 2, 32, [1, 37, 100]),      # GQA 4:1, Smax not a tile multiple
    (2, 64, 4, 1, 16, [1, 64]),            # MQA
    (4, 130, 4, 4, 16, [1, 2, 65, 129]),   # MHA, ragged
    (2, 70, 8, 2, 160, [1, 70]),           # hd 160 (stablelm-12b), G 4
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,KV,hd,lengths", DECODE_CASES)
def test_decode_plain_matches_jax(B, Smax, H, KV, hd, lengths, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        B * Smax, [(B, H, hd), (B, KV, Smax, hd), (B, KV, Smax, hd)], dtype)
    jl = jnp.asarray(lengths, jnp.int32)
    tl = torch.tensor(lengths, dtype=torch.int32)
    out, lse = decode_attention_with_lse_ref(tq, tk, tv, tl)
    plain = decode_attention_ref(tq, tk, tv, tl)
    assert plain.dtype == tq.dtype and plain.shape == (B, H, hd)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, 1)
    j_out = j_dec_ref(jq, jk, jv, jl)
    j_out2, j_lse = j_dec_lse_ref(jq, jk, jv, jl)
    np.testing.assert_allclose(_np(plain), _np(j_out), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(j_out2), **TOL[dtype])
    np.testing.assert_allclose(_np(lse), _np(j_lse), **TOL["float32"])
    # the Pallas kernel, run in interpret mode as tests/test_kernels.py does
    p_out, p_lse = decode_attention_kernel(jq, jk, jv, jl, block_k=32,
                                           interpret=True, return_lse=True)
    np.testing.assert_allclose(_np(plain), _np(p_out), **TOL[dtype])
    np.testing.assert_allclose(_np(lse), _np(p_lse), **TOL["float32"])


def test_flash_decode_model_layout():
    """flash_decode takes the model layout ([B,1,H,hd] / [B,Smax,KV,hd])
    and equals the ref on the transposed cache; impl='reference' is the
    same path; the launch counter does not move on the CPU."""
    B, Smax, H, KV, hd = 2, 40, 8, 2, 16
    _, (q, kc, vc) = _inputs(5, [(B, 1, H, hd), (B, Smax, KV, hd),
                                 (B, Smax, KV, hd)], "float32")
    lengths = torch.tensor([3, 40], dtype=torch.int32)
    before = dec_ops.LAUNCHES
    out = dec_ops.flash_decode(q, kc, vc, lengths)
    ref = decode_attention_ref(q[:, 0], kc.transpose(1, 2),
                               vc.transpose(1, 2), lengths)
    torch.testing.assert_close(out[:, 0], ref, rtol=0, atol=0)
    out2, lse = dec_ops.flash_decode(q, kc, vc, lengths, impl="reference",
                                     return_lse=True)
    ref2, ref_lse = decode_attention_with_lse_ref(
        q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lengths)
    torch.testing.assert_close(out2[:, 0], ref2, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    assert dec_ops.LAUNCHES == before
    with pytest.raises(ValueError):
        dec_ops.flash_decode(q, kc, vc, lengths, impl="pallas")


def _paged_from_dense(kc, vc, bs, rng):
    """Split dense [B,Smax] caches into a scrambled block pool + tables."""
    B, Smax, KV, hd = kc.shape
    nb = Smax // bs
    NB = B * nb + 1                     # block 0 left as scratch
    tables = rng.permutation(np.arange(1, NB)).reshape(B, nb)
    kp = torch.zeros((NB, bs, KV, hd), dtype=kc.dtype)
    vp = torch.zeros((NB, bs, KV, hd), dtype=vc.dtype)
    for b in range(B):
        for j in range(nb):
            kp[tables[b, j]] = kc[b, j * bs:(j + 1) * bs]
            vp[tables[b, j]] = vc[b, j * bs:(j + 1) * bs]
    return kp, vp, torch.from_numpy(tables.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_paged_scrambled(dtype):
    """flash_decode_paged over a scrambled block pool equals flash_decode
    over the dense cache, bitwise, and the gather rebuilds the cache."""
    B, Smax, bs, H, KV, hd = 3, 128, 16, 8, 2, 32
    _, (q, kc, vc) = _inputs(7, [(B, 1, H, hd), (B, Smax, KV, hd),
                                 (B, Smax, KV, hd)], dtype)
    rng = np.random.default_rng(7)
    kp, vp, tables = _paged_from_dense(kc, vc, bs, rng)
    torch.testing.assert_close(dec_ops.gather_kv_blocks(kp, tables), kc,
                               rtol=0, atol=0)
    lengths = torch.tensor([1, 17, 128], dtype=torch.int32)
    out = dec_ops.flash_decode_paged(q, kp, vp, tables, lengths)
    ref = dec_ops.flash_decode(q, kc, vc, lengths)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K2: flash attention, plain version vs JAX ref and Pallas (interpret)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, H, KV, Sq, Skv, hd, causal, window
    (2, 8, 2, 40, 40, 32, True, 0),     # GQA 4:1, Sq not a tile multiple
    (1, 4, 1, 64, 64, 16, True, 0),     # MQA
    (1, 4, 2, 48, 48, 16, True, 16),    # window
    (2, 4, 2, 24, 56, 16, True, 0),     # Sq < Skv (incremental prefill)
    (1, 4, 4, 33, 33, 16, False, 0),    # not causal
    (1, 8, 2, 40, 40, 160, True, 0),    # hd 160 (stablelm-12b), G 4
    (2, 4, 4, 24, 56, 16, False, 0),    # not causal, Sq < Skv (cross-attn)
    (2, 4, 4, 1, 48, 16, False, 0),     # not causal, one query (decode)
    (1, 4, 4, 20, 48, 64, False, 0),    # whisper's hd 64, G 1, Sq < Skv
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,window", FLASH_CASES)
def test_flash_plain_matches_jax(B, H, KV, Sq, Skv, hd, causal, window,
                                 dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        Sq * Skv + H, [(B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)],
        dtype)
    plain = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert plain.dtype == tq.dtype and plain.shape == (B, H, Sq, hd)
    j_out = j_flash_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(plain), _np(j_out), **TOL[dtype])
    p_out = flash_attention_kernel(jq, jk, jv, causal=causal, window=window,
                                   block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(_np(plain), _np(p_out), **TOL[dtype])
    # model-layout wrapper: [B,S,heads,hd] in and out, plain on the CPU
    before = flash_ops.LAUNCHES
    wrapped = flash_ops.flash_attention(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        causal=causal, window=window)
    torch.testing.assert_close(wrapped.transpose(1, 2), plain, rtol=0,
                               atol=0)
    assert flash_ops.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,window,chunk", [
    (40, 40, 0, 1024), (24, 56, 0, 1024), (48, 48, 16, 1024),
    (40, 72, 0, 16)])
def test_model_causal_attention_matches_jax(Sq, Skv, window, chunk, dtype):
    """The model's full-sequence attention on the CPU (the path K2 takes on
    the card) places q[i] at kv position i + Skv - Sq, as the JAX
    ``causal_attention`` does with ``q_offset = Skv - Sq``, also when it
    runs in query chunks."""
    B, H, KV, hd = 2, 8, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        Sq + Skv, [(B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)],
        dtype)
    before = flash_ops.LAUNCHES
    out = attention.causal_attention(tq, tk, tv, window=window, chunk=chunk)
    j_out = jattn.causal_attention(jq, jk, jv, q_offset=Skv - Sq,
                                   window=window, chunk=chunk)
    assert out.dtype == tq.dtype and out.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(_np(out), _np(j_out), **TOL[dtype])
    assert flash_ops.LAUNCHES == before


# ---------------------------------------------------------------------------
# K2's chunked-prefill entry: plain version vs the JAX package's decode
# step with T > 1 new tokens a row (_qkv, write_kv, decode_attention)
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs import base as tcfgs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    chunked_attention_ref  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.common import rope_cos_sin  # noqa: E402

# rows of a chunked step at T new tokens over Smax slots: a free slot
# (lengths 0: every query before the cache, nothing written), a prompt
# shorter than the chunk (queries before position 0 and after it), one
# inside the cache, one whose chunk overruns its end (positions dropped)
CHUNK_LENGTHS = [0, 17, 45, 84]


def _chunk_step(hd, G, KV, norm, Smax, lengths, T, dtype, seed):
    """One chunked step of one layer in both packages on the same numpy
    inputs: (torch out, torch caches, jax out, jax caches, positions)."""
    B, D = len(lengths), 64
    H = G * KV
    rng = np.random.default_rng(seed)
    arrs = {"x": (B, T, D), "wq": (D, H * hd), "wk": (D, KV * hd),
            "wv": (D, KV * hd), "ck": (B, Smax, KV, hd),
            "cv": (B, Smax, KV, hd)}
    a = {k: (rng.standard_normal(s) / (np.sqrt(D) if k[0] == "w" else 1.0)
             ).astype(np.float32) for k, s in arrs.items()}
    a["qn"] = (1.0 + 0.2 * rng.standard_normal(hd)).astype(np.float32)
    a["kn"] = (1.0 + 0.2 * rng.standard_normal(hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    pos = lens[:, None] - T + np.arange(T, dtype=np.int32)[None]
    kw = dict(name="chunk", family="dense", num_layers=1, d_model=D,
              num_heads=H, num_kv_heads=KV, d_ff=D, vocab_size=8,
              head_dim=hd, qk_norm=norm, rope_theta=1e6)
    j = {k: jnp.asarray(v).astype(JD[dtype]) for k, v in a.items()}
    jp = {"wq": j["wq"], "wk": j["wk"], "wv": j["wv"]}
    if norm:
        jp["q_norm"], jp["k_norm"] = {"scale": j["qn"]}, {"scale": j["kn"]}
    jcfg = jcfgs.ModelConfig(**kw)
    q, k, v = jblocks._qkv(jp, j["x"], jcfg, jnp.asarray(pos))
    jlen = jnp.asarray(lens)
    jck, jcv = jattn.write_kv(j["ck"], j["cv"], k, v, jlen - T)
    j_out = jattn.decode_attention(q, jck, jcv, jlen)

    t = {k: torch.from_numpy(v).to(TD[dtype]) for k, v in a.items()}
    tq = (t["x"] @ t["wq"]).reshape(B, T, H, hd)
    tk = (t["x"] @ t["wk"]).reshape(B, T, KV, hd)
    tv = (t["x"] @ t["wv"]).reshape(B, T, KV, hd)
    cos, sin = rope_cos_sin(torch.from_numpy(pos), hd, 1e6)
    ck, cv = t["ck"].clone(), t["cv"].clone()
    before = (flash_ops.LAUNCHES, flash_ops.CHUNKED_LAUNCHES)
    out = flash_ops.chunked_attention(
        tq, tk, tv, ck, cv, torch.from_numpy(lens),
        q_norm=t["qn"] if norm else None, k_norm=t["kn"] if norm else None,
        eps=jcfg.norm_eps, cos=cos, sin=sin)
    assert (flash_ops.LAUNCHES, flash_ops.CHUNKED_LAUNCHES) == before
    return out, (ck, cv, t["ck"], t["cv"]), j_out, (jck, jcv), pos


def _check_chunk_step(step, Smax, T, dtype):
    """Queries at positions >= 0 and the caches equal JAX's within the
    tolerance; queries before position 0 (no key: the dense block averages
    every slot there, the kernels' contract is zeros) output exactly 0,
    and the slots JAX's scatter wraps a negative position to keep the
    plain version's initial contents (it drops the position)."""
    out, (ck, cv, ck0, cv0), j_out, (jck, jcv), pos = step
    seen = pos >= 0
    np.testing.assert_allclose(_np(out)[seen], _np(j_out)[seen],
                               **TOL[dtype])
    assert not _np(out)[~seen].any()
    wrapped = np.zeros(ck.shape[:2], bool)
    for b, p in zip(*np.nonzero(~seen)):
        wrapped[b, pos[b, p] + Smax] = True
    for got, want, init in ((ck, jck, ck0), (cv, jcv, cv0)):
        np.testing.assert_allclose(_np(got)[~wrapped], _np(want)[~wrapped],
                                   **TOL[dtype])
        np.testing.assert_array_equal(_np(got)[wrapped], _np(init)[wrapped])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("hd", [64, 128, 160, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_chunked_plain_matches_jax(G, hd, norm, dtype):
    """The chunked entry's plain version (qk-norm or none, RoPE, the cache
    append at each row's offset, attention with per-row query offsets)
    against the JAX package's chunked decode step, T = 32 over 64 slots,
    ragged lengths (CHUNK_LENGTHS)."""
    T, Smax = 32, 64
    step = _chunk_step(hd, G, 2, norm, Smax, CHUNK_LENGTHS, T, dtype,
                       seed=hd * G + norm)
    _check_chunk_step(step, Smax, T, dtype)


@pytest.mark.parametrize("nb,lengths", [
    (1, [0, 32, 20, 40]),             # one 32-slot block: a chunk fills it
    (64, [0, 32, 1000, 2048, 2050]),  # 2,048 slots: the cell's widest view
])
def test_chunked_plain_matches_jax_cell_width(nb, lengths):
    """The served chunk (T = 32, qk-norm, hd 128, G 8) over the narrowest
    and the widest cache view the batcher gathers (nb blocks of 32)."""
    T, Smax = 32, 32 * nb
    step = _chunk_step(128, 8, 1, True, Smax, lengths, T, "float32",
                       seed=nb)
    _check_chunk_step(step, Smax, T, "float32")


def _full(arch, **kw):
    return dataclasses.replace(tcfgs.get_config(arch), **kw)


@pytest.mark.parametrize("cfg_of,T,window,dtype,takes", [
    (lambda: _full("qwen3-32b"), 32, 0, torch.bfloat16, True),
    (lambda: _full("proxy-8b"), 32, 0, torch.bfloat16, True),
    (lambda: _full("oracle-70b"), 32, 0, torch.bfloat16, True),
    (lambda: _full("command-r-35b"), 32, 0, torch.bfloat16, True),
    (lambda: _full("qwen2-moe-a2.7b"), 32, 0, torch.bfloat16, True),
    (lambda: _full("stablelm-12b"), 32, 0, torch.bfloat16, True),  # hd 160
    (lambda: _full("qwen3-32b"), 32, 0, torch.float32, True),
    (lambda: _full("qwen3-32b"), 1, 0, torch.bfloat16, False),     # K1's
    (lambda: _full("recurrentgemma-9b"), 32, 2048, torch.bfloat16, False),
    (lambda: _full("qwen2-vl-7b"), 32, 0, torch.bfloat16, False),  # M-RoPE
    (lambda: _full("qwen3-32b", head_dim=96), 32, 0, torch.bfloat16,
     False),                                          # hd not K2's
    (lambda: _full("recurrentgemma-9b", num_heads=128), 32, 0,
     torch.bfloat16, False),                          # G 128 > BM 64
    (lambda: _full("qwen3-32b"), 32, 0, torch.float16, False),
    (lambda: _full("qwen3-32b", use_layernorm=True), 32, 0, torch.bfloat16,
     False),                                          # LayerNorm qk-norm
])
def test_chunked_kernel_dispatch_rule(cfg_of, T, window, dtype, takes):
    """Which decode calls K2's chunked entry takes on the card (read off
    the layer's params and config, no model name): several new tokens a
    row, no window, no M-RoPE, an RMS qk-norm or none, hd in HEAD_DIMS, G
    <= BM, bf16 or fp32.  A CPU tensor always keeps the plain path."""
    cfg = cfg_of()
    params = tblocks.attn_init(torch.Generator().manual_seed(0),
                               dataclasses.replace(cfg, d_model=8),
                               torch.float32)
    if cfg.use_layernorm and cfg.qk_norm:
        params["q_norm"]["bias"] = torch.zeros(cfg.head_dim)
    assert attention.chunked_prefill_fits(cfg, params, T, window,
                                          dtype) is takes
    x = torch.zeros((2, T, 8), dtype=dtype)
    assert attention.takes_chunked_kernel(x, cfg, params, window) is False


def _chunked_route_on_cpu(monkeypatch):
    """Make the CPU take the chunked route (its plain version), counting
    each call as the card's launch would."""
    fits = attention.chunked_prefill_fits
    monkeypatch.setattr(attention, "takes_chunked_kernel",
                        lambda x, cfg, params, window: fits(
                            cfg, params, x.shape[1], window, x.dtype))
    plain = flash_ops.chunked_attention

    def counted(*a, **kw):
        flash_ops.CHUNKED_LAUNCHES += 2
        return plain(*a, **kw)

    monkeypatch.setattr(flash_ops, "chunked_attention", counted)


@pytest.mark.parametrize("positions", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,hd", [("qwen3-32b", 64), ("proxy-8b", 128),
                                     ("stablelm-12b", 160)])
def test_chunked_route_is_the_plain_decode_bit_for_bit(arch, hd, dtype,
                                                       positions,
                                                       monkeypatch):
    """The model's chunked route (projections, the RoPE tables made once a
    forward, the entry's plain version) gives the plain decode path's
    hidden states and caches bit for bit, on rows as the batcher gives
    them (lengths >= T; one chunk overruns the cache).  A call without
    positions (every new token rotated at the row's last position) keeps
    the plain path."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config(arch), head_dim=hd,
                              dtype="float32" if dtype == torch.float32
                              else "bfloat16")
    model = model_zoo.build(cfg)
    params = model.init_params(torch.Generator().manual_seed(1))
    B, T, Smax = 3, 8, 32
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(4, cfg.vocab_size, (B, T), generator=gen)
    lens = torch.tensor([0, 13, 28], dtype=torch.int32)   # 36 overruns

    def run():
        cache = model.init_cache(B, Smax)
        for leaf in cache["periods"]["b0"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                                   .manual_seed(3)).to(leaf.dtype))
        cache["len"] = lens.clone()
        batch = {"tokens": toks}
        if positions:
            batch["positions"] = (lens[:, None]
                                  + torch.arange(T, dtype=torch.int32)[None])
        out = model.apply(params, batch, mode="decode", cache=cache)
        return (out["hidden"], out["cache"]["periods"]["b0"],
                out["chunked_layers"])

    plain_h, plain_c, plain_n = run()
    n = flash_ops.CHUNKED_LAUNCHES
    _chunked_route_on_cpu(monkeypatch)
    h, c, layers = run()
    assert plain_n == 0 and layers == cfg.num_layers * positions
    assert flash_ops.CHUNKED_LAUNCHES - n == 2 * layers
    assert torch.equal(h, plain_h)
    assert all(torch.equal(c[k], plain_c[k]) for k in ("k", "v"))


def test_batcher_counts_prefill_layers_through_the_kernel(monkeypatch):
    """``stats()["prefill_attn_kernel_layers"]`` counts the layers of
    prefill steps that took the chunked entry (all of them on a model the
    rule admits); the results are those of the plain route."""
    from repro_torch.inference.backend import SCORE, Request
    from repro_torch.inference.engine import TorchInferenceEngine

    def serve():
        eng = TorchInferenceEngine(
            dataclasses.replace(tcfgs.get_smoke_config("qwen3-32b"),
                                head_dim=64), device="cpu", max_batch=2,
            max_seq=96, backend="continuous")
        reqs = [Request("x" * n, eng.arch, SCORE, request_id=i)
                for i, n in enumerate((70, 20, 41))]
        out = eng.submit_batch(reqs)
        return [r.score for r in out], eng.backend_stats()

    plain, st0 = serve()
    _chunked_route_on_cpu(monkeypatch)
    got, st = serve()
    assert st0["prefill_attn_kernel_layers"] == 0
    assert st["prefill_attn_kernel_layers"] == 2 * st["prefill_steps"] > 0
    assert got == plain


# ---------------------------------------------------------------------------
# K4: RG-LRU scan, plain version vs JAX ref and Pallas (interpret)
# ---------------------------------------------------------------------------

from repro.kernels.rglru_scan.kernel import rglru_scan_kernel  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_rglru_ref  # noqa
from repro.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel  # noqa: E402
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_rwkv_ref  # noqa
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402


def _decays(seed, shape, dtype):
    """Decays in (0, 1), as the models make them, rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape) - 2.0))).astype(
        np.float32)
    return jnp.asarray(a).astype(JD[dtype]), torch.from_numpy(a).to(TD[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", [
    (2, 24, 256),     # S and W multiples of the Pallas blocks below
    (3, 13, 200),     # S and W padded by the Pallas kernel
    (1, 1, 64)])      # a single step
def test_rglru_plain_matches_jax(B, S, W, dtype):
    """The plain version of K4 equals the JAX ``ref.py`` and the Pallas
    kernel (interpret mode, blocks of 8 steps x 128 channels, so S and W
    are padded in the second case) within the fp32 tolerance: the state
    is fp32 whatever the inputs' type."""
    ja, ta = _decays(B * S + W, (B, S, W), dtype)
    (jb, jh0), (tb, th0) = _inputs(B + S + W, [(B, S, W), (B, W)], dtype)
    jh0, th0 = jh0.astype(jnp.float32), th0.float()
    hs, hT = rglru_scan_ref(ta, tb, th0)
    assert hs.dtype == hT.dtype == torch.float32
    assert hs.shape == (B, S, W) and hT.shape == (B, W)
    j_hs, j_hT = j_rglru_ref(ja, jb, jh0)
    np.testing.assert_allclose(_np(hs), _np(j_hs), **TOL["float32"])
    np.testing.assert_allclose(_np(hT), _np(j_hT), **TOL["float32"])
    p_hs, p_hT = rglru_scan_kernel(ja, jb, jh0, block_w=128, block_t=8,
                                   interpret=True)
    np.testing.assert_allclose(_np(hs), _np(p_hs), **TOL["float32"])
    np.testing.assert_allclose(_np(hT), _np(p_hT), **TOL["float32"])
    # the wrapper takes the plain version on the CPU and counts nothing
    before = rglru_ops.LAUNCHES
    w_hs, w_hT = rglru_ops.rglru_scan(ta, tb, th0)
    assert torch.equal(w_hs, hs) and torch.equal(w_hT, hT)
    assert rglru_ops.LAUNCHES == before
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(ta, tb, th0, impl="pallas")


# ---------------------------------------------------------------------------
# K5: RWKV-6 wkv scan, plain version vs JAX ref and Pallas (interpret)
# ---------------------------------------------------------------------------


def _rwkv_inputs(seed, B, S, H, hd, dtype):
    (jr, jk, jv, ju, js0), (tr, tk, tv, tu, ts0) = _inputs(
        seed, [(B, S, H, hd)] * 3 + [(H, hd), (B, H, hd, hd)], dtype)
    jw, tw = _decays(seed + 1, (B, S, H, hd), "float32")
    ju, tu = ju.astype(jnp.float32) * 0.1, tu.float() * 0.1
    js0, ts0 = js0.astype(jnp.float32), ts0.float()
    return (jr, jk, jv, jw, ju, js0), (tr, tk, tv, tw, tu, ts0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hd", [
    (2, 16, 2, 16),     # S a multiple of the Pallas time block below
    (1, 13, 3, 32),     # S padded by the Pallas kernel
    (2, 1, 2, 16)])     # a single (decode) step
def test_rwkv6_plain_matches_jax(B, S, H, hd, dtype):
    """The plain version of K5 equals the JAX ``ref.py`` and the Pallas
    kernel (interpret mode, time blocks of 8) on r, k, v in ``dtype`` with
    fp32 decays, bonus and state, within the fp32 tolerance."""
    j_in, t_in = _rwkv_inputs(B * S * H + hd, B, S, H, hd, dtype)
    o, sT = rwkv6_scan_ref(*t_in)
    assert o.dtype == sT.dtype == torch.float32
    assert o.shape == (B, S, H, hd) and sT.shape == (B, H, hd, hd)
    j_o, j_sT = j_rwkv_ref(*j_in)
    np.testing.assert_allclose(_np(o), _np(j_o), **TOL["float32"])
    np.testing.assert_allclose(_np(sT), _np(j_sT), **TOL["float32"])
    p_o, p_sT = rwkv6_scan_kernel(*j_in, block_t=8, interpret=True)
    np.testing.assert_allclose(_np(o), _np(p_o), **TOL["float32"])
    np.testing.assert_allclose(_np(sT), _np(p_sT), **TOL["float32"])
    before = rwkv_ops.LAUNCHES
    w_o, w_sT = rwkv_ops.rwkv6_scan(*t_in)
    assert torch.equal(w_o, o) and torch.equal(w_sT, sT)
    assert rwkv_ops.LAUNCHES == before
    with pytest.raises(ValueError):
        rwkv_ops.rwkv6_scan(*t_in, impl="pallas")


def test_rwkv6_plain_state_chaining():
    """Two calls over the halves, the second from the first's state, equal
    one call over the whole sequence (as tests/test_kernels.py checks for
    the JAX version); a step with decay 1 and k = 0 leaves the state
    unchanged (the model's prefill padding)."""
    B, S, H, hd = 2, 20, 2, 16
    _, (r, k, v, w, u, s0) = _rwkv_inputs(31, B, S, H, hd, "float32")
    o, sT = rwkv6_scan_ref(r, k, v, w, u, s0)
    h = S // 2
    o1, s1 = rwkv6_scan_ref(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
    o2, s2 = rwkv6_scan_ref(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
    np.testing.assert_allclose(_np(torch.cat([o1, o2], 1)), _np(o),
                               **TOL["float32"])
    np.testing.assert_allclose(_np(s2), _np(sT), **TOL["float32"])
    pad_k, pad_w = torch.zeros_like(k[:, :3]), torch.ones_like(w[:, :3])
    _, s3 = rwkv6_scan_ref(r[:, :3], pad_k, v[:, :3], pad_w, u, sT)
    assert torch.equal(s3, sT)
