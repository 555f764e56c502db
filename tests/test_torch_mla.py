"""Moonlight-16B-A3B's DeepSeek-V3 block in the port, on the CPU in fp32
(a port-only id: the JAX package has no such block).

* The absorbed form over a paged latent cache (chunks of 32 with ragged
  lengths, then single-token steps) gives the logits of the port's own
  full-sequence pass in the decompressed form.
* The sigmoid router chooses by s + b and weights by s, renormalised and
  scaled, against a hand-computed case.
* Layer 0 is dense and the rest are MoE, in the tree and in the forward;
  the analytic parameter count is the tree's.
* The engine serves the model on the continuous batcher, with the latent
  leaf paged, as its static path does; with the recorder on, the MLA
  layers' ``layer.attn`` / ``layer.ffn`` spans nest in ``step.forward``
  and the MoE layers note the experts their real tokens reached; with
  the gate off they record and note nothing.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base  # noqa: E402
from repro_torch.inference import continuous  # noqa: E402
from repro_torch.inference.backend import COMPLETE, SCORE, Request  # noqa
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from repro_torch.inference.paged_kv import PagedKVCache  # noqa: E402
from repro_torch.models import blocks, model_zoo  # noqa: E402
from repro_torch.models.common import rotate_pairs  # noqa: E402
from repro_torch.obs import Observability, engine_ring  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402

ARCH = "moonlight-16b-a3b"
TOL = 5e-6          # fp32, the two forms sum in other orders (read 1.4e-6)


def smoke():
    return dataclasses.replace(base.get_smoke_config(ARCH), dtype="float32")


@pytest.fixture(scope="module")
def model():
    m = model_zoo.build(smoke())
    return m, m.init_params(torch.Generator().manual_seed(3))


def full_logits(m, p, seq):
    h = m.apply(p, {"tokens": seq[None]}, mode="train")["hidden"]
    return m.logits_of(p, h)[0]


def test_the_id_is_the_ports_own():
    cfg = base.get_config(ARCH)
    assert ARCH in base.PORT_ONLY_IDS
    assert ARCH not in base.KNOWN_IDS and ARCH not in base.ARCH_IDS
    assert cfg.block_pattern == (base.MLA,) * 27
    assert cfg.q_dim == 16 * (128 + 64) and cfg.first_k_dense == 1
    assert round(cfg.param_count() / 1e9, 2) == 15.96
    assert continuous.supports(cfg) and continuous.supports(smoke())


def test_rotate_pairs_turns_interleaved_pairs():
    x = torch.randn(5, 8)
    ang = torch.randn(5, 4)
    cos, sin = torch.cos(ang), torch.sin(ang)
    got = rotate_pairs(x, cos, sin)
    a, b = x[:, 0::2], x[:, 1::2]
    want = torch.cat([a * cos - b * sin, b * cos + a * sin], -1)
    assert torch.allclose(got, want, atol=1e-6)


def test_chunked_steps_and_decode_steps_equal_the_full_pass(model):
    """Three rows of 70, 45 and 90 tokens enter a paged latent cache 32 at
    a time (ragged tails, the rows finishing at different steps), as the
    batcher's chunked prefill does, then take three single-token steps;
    every position's logits equal the full pass over the row."""
    m, p = model
    g = torch.Generator().manual_seed(11)
    n = [70, 45, 90]
    seqs = [torch.randint(4, 512, (k + 3,), generator=g) for k in n]
    kv = PagedKVCache(m, block_size=8, num_blocks=64)
    leaf = kv.pool["periods"]["b0"]["ckv"]
    assert leaf.shape == (3, 64, 8, 32 + 8)       # [P, NB, bs, r + rope]
    B, C, nb = 3, 32, 16
    tables = torch.tensor([kv.alloc(nb) for _ in range(B)], dtype=torch.int32)
    lens = torch.zeros(B, dtype=torch.int32)
    got = [[] for _ in range(B)]

    def step(counts, width):
        nonlocal lens
        toks = torch.zeros(B, width, dtype=torch.long)
        for b in range(B):
            a = int(lens[b])
            toks[b, :counts[b]] = seqs[b][a:a + counts[b]]
        pos = lens[:, None] + torch.arange(width, dtype=torch.int32)[None]
        cache = kv.gather(kv.pool, tables, lens)
        out = m.apply(p, {"tokens": toks, "positions": pos}, mode="decode",
                      cache=cache)
        cnt = torch.tensor(counts, dtype=torch.int32)
        kv.scatter(kv.pool, out["cache"], tables, lens, cnt, width)
        lg = m.logits_of(p, out["hidden"])
        for b in range(B):
            got[b].append(lg[b, :counts[b]])
        lens = lens + cnt

    while any(int(lens[b]) < n[b] for b in range(B)):
        step([min(C, n[b] - int(lens[b])) for b in range(B)], C)
    for _ in range(3):
        step([1] * B, 1)
    for b in range(B):
        want = full_logits(m, p, seqs[b])
        err = (torch.cat(got[b]) - want).abs().max().item()
        assert err < TOL, (b, err)


def test_sigmoid_routing_by_hand():
    """Four experts, top 2, the router the identity: s = sigmoid(x); the
    bias moves expert 0 (the largest s) out of the choice and expert 2
    in; the gates are s over the chosen s' sum, times 2.446."""
    m = base.DeepSeekMoEConfig(num_experts=4, num_experts_per_tok=2,
                               expert_d_ff=8, routed_scale=2.446)
    x = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    bias = torch.tensor([-1.0, 0.0, 0.5, 0.0])
    gates, _ = blocks._route(torch.eye(4), x, m, bias)
    sig = [1 / (1 + math.exp(-v)) for v in (2.0, 1.0, 0.0, -1.0)]
    tot = sig[1] + sig[2]
    want = [0.0, sig[1] / tot * 2.446, sig[2] / tot * 2.446, 0.0]
    assert gates[0].tolist() == pytest.approx(want, abs=1e-6)
    # without the bias: experts 0 and 1
    gates, _ = blocks._route(torch.eye(4), x, m)
    tot = sig[0] + sig[1]
    assert gates[0].tolist() == pytest.approx(
        [sig[0] / tot * 2.446, sig[1] / tot * 2.446, 0.0, 0.0], abs=1e-6)


def test_layer_zero_is_dense_and_the_rest_moe(model, monkeypatch):
    cfg = base.get_config(ARCH)
    tree = model_zoo.abstract_params(cfg)
    assert sum(t.numel() for t in leaves(tree)) == cfg.param_count()
    first, rest = tree["layers"][0], tree["layers"][1:]
    assert "moe" not in first and first["mlp"]["wi"].shape == (2048, 11264)
    assert len(rest) == 26
    for lay in rest:
        assert "mlp" not in lay
        assert lay["moe"]["experts"]["wi"].shape == (64, 2048, 1408)
        assert lay["moe"]["router"]["bias"].shape == (64,)
        assert lay["moe"]["shared"]["wi"].shape == (2048, 2816)
    assert tree["layers"][5]["attn"]["wkv_b"].shape == (512, 16 * 256)
    m, p = model
    assert sum(t.numel() for t in leaves(p)) == smoke().param_count()
    calls = []
    real = blocks.moe_apply
    monkeypatch.setattr(blocks, "moe_apply",
                        lambda *a: calls.append(1) or real(*a))
    dense = []
    real_mlp = blocks.apply_mlp
    monkeypatch.setattr(blocks, "apply_mlp",
                        lambda *a: dense.append(1) or real_mlp(*a))
    m.apply(p, {"tokens": torch.randint(4, 512, (1, 9))}, mode="train")
    # layer 0's MLP, then layers 1-2's experts, each with its shared expert
    assert len(calls) == 2 and len(dense) == 1 + 2


def _requests(model):
    reqs = [Request("is the clause present? " + "ab cd " * (7 * i + 2),
                    model, SCORE, request_id=i + 1) for i in range(5)]
    reqs += [Request("summarise " + "w x " * (5 * i + 3), model, COMPLETE,
                     max_tokens=4, request_id=10 + i) for i in range(2)]
    return reqs


def _engine(backend):
    return TorchInferenceEngine(smoke(), device="cpu", max_batch=3,
                                max_seq=160, seed=4, backend=backend)


def test_the_batcher_serves_it_as_the_static_path():
    cont, stat = _engine("continuous"), _engine("static")
    assert cont._batcher is not None
    leaf = cont._batcher.kv.pool["periods"]["b0"]["ckv"]
    assert leaf.shape[-1] == 32 + 8
    a = cont.submit_batch(_requests(cont.arch))
    b = stat.submit_batch(_requests(stat.arch))
    for x, y in zip(a, b):
        if x.kind == SCORE:
            assert abs(x.score - y.score) < 1e-5
        else:
            assert x.text == y.text and x.tokens_out == y.tokens_out == 4


def test_layer_spans_and_expert_counts():
    eng = _engine("continuous")
    eng.obs = Observability(enabled=True)
    eng.submit_batch(_requests(eng.arch))
    ring = engine_ring()
    tree = ring.get(f"{eng.engine_id}/{eng._batcher.waves}")
    steps = [s for s in tree["children"] if s["kind"] == "engine.step"]
    E, k = 8, 3
    assert steps
    for s in steps:
        fwd = [c for c in s["children"] if c["kind"] == "step.forward"][0]
        kinds = [c["kind"] for c in fwd["children"]]
        assert kinds == ["layer.attn", "layer.ffn"] * 3
        ffn = [c for c in fwd["children"] if c["kind"] == "layer.ffn"]
        assert "experts_hit" not in ffn[0]["attrs"]          # dense layer 0
        tokens = s["attrs"]["tokens"]
        for c in ffn[1:]:
            a, c0 = c["attrs"], c
            assert fwd["t0"] <= c0["t0"] <= c0["t1"] <= fwd["t1"]
            assert 1 <= a["experts_hit"] <= min(E, k * tokens)
            assert math.ceil(k * tokens / E) <= a["max_expert_tokens"] \
                <= tokens


def test_with_the_gate_off_the_layers_record_nothing(monkeypatch):
    from repro_torch.obs import engine as obs_engine
    from repro_torch.obs import trace as trace_mod
    made = []
    real_span = trace_mod.Span

    class Counted(real_span):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a[0])
            super().__init__(*a)

    monkeypatch.setattr(trace_mod, "Span", Counted)
    seen = []
    real_note = obs_engine.note
    monkeypatch.setattr(obs_engine, "note",
                        lambda **kw: seen.append(kw) or real_note(**kw))
    eng = _engine("continuous")
    eng.obs = Observability(enabled=False)
    before = engine_ring().ids()
    out = eng.submit_batch(_requests(eng.arch))
    assert len(out) == 7 and made == [] and seen == []
    assert engine_ring().ids() == before and obs_engine.recording() is None
