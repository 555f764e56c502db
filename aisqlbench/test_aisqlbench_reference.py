"""The plain reference against the port's CPU path, both in fp32 on the
same seeded weights: SCOREs through chunked prefill and the paged pool,
and the logits of the port's whole pass at every position."""
import dataclasses

import pytest
import torch

from aisqlbench import harness, judge, spec, tokens

QWEN3 = spec.load_arch("qwen3")
Reference = QWEN3.Reference
SEED = 2**31 + 12345
PROMPTS = ["Does this document report a product defect? " + "abc de " * k
           for k in (1, 9, 14)]


def engine(arch):
    from repro_torch.configs import base
    from repro_torch.inference.engine import TorchInferenceEngine
    cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="float32")
    eng = TorchInferenceEngine(cfg, max_batch=2, max_seq=256,
                               backend="continuous", device="cpu")
    model = harness.model_dict(
        eng.cfg, spec.Bench().config_file(arch)["model"])
    harness.fill_weights(eng.params, QWEN3, model, SEED, "cpu")
    return eng, model


def test_scores():
    from repro_torch.inference.backend import SCORE, Request
    eng, model = engine("qwen3-32b")
    taps = harness.Taps(eng, QWEN3, model, trace=False)
    taps.on = True
    try:
        out = eng.submit_batch([Request(p, eng.arch, SCORE, request_id=i)
                                for i, p in enumerate(PROMPTS)])
    finally:
        taps.close()
    seqs = [tokens.encode(p) for p in PROMPTS]
    lg = Reference(model, SEED, "cpu").run(seqs, [[len(s) - 1] for s in seqs])
    for p, r, g in zip(PROMPTS, out, lg):
        assert judge.logit_of(r.score) == pytest.approx(judge.d_of(g[-1]),
                                                        abs=2e-4)
        assert taps.scores[p] == r.score
    assert sum(s[3] for s in taps.steps) == sum(len(s) for s in seqs)


def test_whole_pass_logits():
    """The port's whole pass over the same tokens, at every position."""
    eng, model = engine("qwen3-32b")
    seqs = [tokens.encode(p) for p in PROMPTS]
    pos = [list(range(len(s))) for s in seqs]
    lg = Reference(model, SEED, "cpu").run(seqs, pos)
    for q, p, g in zip(seqs, pos, lg):
        with torch.no_grad():
            h = eng.model.apply(eng.params, {"tokens": torch.tensor([q])},
                                mode="train")["hidden"]
            port = eng.model.logits_of(eng.params, h[0, p])
        assert torch.allclose(port, g, atol=2e-4, rtol=1e-4)


def test_control_rounds_to_fp8():
    eng, model = engine("qwen3-32b")
    seqs = [tokens.encode(p) for p in PROMPTS]
    pos = [[len(s) - 1] for s in seqs]
    a = Reference(model, SEED, "cpu").run(seqs, pos)
    b = Reference(model, SEED, "cpu", "fp8").run(seqs, pos)
    gap = max(float((x - y).abs().max()) for x, y in zip(a, b))
    assert gap > 1e-3
