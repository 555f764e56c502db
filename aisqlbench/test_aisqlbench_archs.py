"""Architectures found by name (``archs/<arch>.py``).

* qwen3 is pinned, bit for bit: the seeded draw of every group of its
  smoke model, the full model's groups (names, shapes, laws, types) and
  the reference's fp32 and fp8 logits on the smoke model, each a sha256
  taken before the architecture moved out of the harness.
* A configuration is held to the port's ``ModelConfig`` key by key,
  nested sections too.
* A mixture-of-experts architecture is added to a copy of the benchmark
  by new files and entries alone (``_testarch_moe.py`` as
  ``archs/tinymoe.py``, a configuration over the port's qwen2-moe-a2.7b
  smoke model, a cell) and runs end to end on the CPU, traced and not,
  its check passing; with the shared expert left out of its reference
  the check fails.
"""
import dataclasses
import hashlib
import json
import time

import pytest
import torch

from aisqlbench import _testcell, harness, spec, tokens, weights

QWEN3 = spec.load_arch("qwen3")
SEED = 2**31 + 12345
PROMPTS = ["Does this document report a product defect? " + "abc de " * k
           for k in (1, 9, 14)]

DRAWS = {
    ("bfloat16", "embed"):
        "2b53e9495f3ee251f92c2f6538cad4035c60da28443a31817c8b2a0a944c2751",
    ("bfloat16", "layers.0"):
        "a50052a89aa7293e0af2ec6a2add934873ad56b34fc0dda0712725063376e04e",
    ("bfloat16", "layers.1"):
        "0cb389d250b168f0ea2b443aef7556770f1b3d44ceadb21186151d6ff7fb3170",
    ("bfloat16", "final_norm"):
        "ad1a84cba785083b95dd0d5fa4bf562cb6ece4d8ca4ef6d6500aaff2a46adcd4",
    ("bfloat16", "lm_head"):
        "4af8d9e9f469df3033e94bb2ed02bef94708f3b75246a46ad4c20fb1019e6225",
    ("float32", "embed"):
        "3d9a9e1bccf45805c333e416246853a176574a36078ca339704cbf9b57dd232b",
    ("float32", "layers.0"):
        "83156cbc125a37c011e5519e52df94467b922a5d76f6e017ac430a1e31520c6f",
    ("float32", "layers.1"):
        "b0cd7b764bd0c4ab1c65a3c314cdbf8b16f17a706e37046a42308c461560e5e9",
    ("float32", "final_norm"):
        "58304afcdb851cece5c05d91ac802b8ae32bb2db00c527820525e0fb38ba92de",
    ("float32", "lm_head"):
        "49c4c9a19d57d1673506b826226b34a263f371aadcae63a558c9f0324144b4db",
}
# the reference's logits at every position of PROMPTS, on one thread (the
# CPU's matrix products round otherwise where they split their work)
LOGITS = {
    ("bfloat16", "fp32"):
        "315b24abb744ec11a7c9c5432dda4a90f4390ca5dd3072d036ab80b4a400d896",
    ("bfloat16", "fp8"):
        "965ca4a674664fef5592574ffd92338686b060a07e38119a964e7f389a46f5e5",
    ("float32", "fp32"):
        "6ddd28f6fce1aa3bd23f48702a591a90246803f552cb94ffce85fb543590c456",
    ("float32", "fp8"):
        "b3f09a57e10e64f6ff469c546b4cfcf7c77c3a0a1cb5d91951370597373e15ae",
}
FULL_GROUPS = \
    "8fc5ad37044c61a8202c44d1cec2f7db8e5cadff3273b4ef78fdc42e401a5d64"


def qwen3_file():
    return spec.Bench().config_file("qwen3-32b")


def smoke_model(dtype):
    from repro_torch.configs import base
    cfg = dataclasses.replace(base.get_smoke_config("qwen3-32b"),
                              dtype=dtype)
    return harness.model_dict(cfg, qwen3_file()["model"])


@pytest.mark.parametrize("dtype,group", sorted(DRAWS))
def test_qwen3_draws_are_pinned(dtype, group):
    m = smoke_model(dtype)
    g = dict(QWEN3.groups(m))
    h = hashlib.sha256()
    for name, x in weights.draw(m, SEED, (group, g[group]), "cpu"):
        h.update(name.encode())
        h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == DRAWS[dtype, group]


def test_qwen3_groups_of_the_full_model_are_pinned():
    groups = QWEN3.groups(qwen3_file()["model"])
    assert len(groups) == 64 + 3
    digest = hashlib.sha256(json.dumps(groups).encode()).hexdigest()
    assert digest == FULL_GROUPS


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,precision", sorted(LOGITS))
def test_qwen3_reference_logits_are_pinned(one_thread, dtype, precision):
    seqs = [tokens.encode(p) for p in PROMPTS]
    pos = [list(range(len(s))) for s in seqs]
    lg = QWEN3.Reference(smoke_model(dtype), SEED, "cpu", precision).run(
        seqs, pos)
    h = hashlib.sha256()
    for t in lg:
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == LOGITS[dtype, precision]


def test_an_unknown_arch_is_refused(tmp_path):
    with pytest.raises(KeyError, match="no architecture"):
        spec.load_arch("no-such-arch")
    _testcell.copy_bench(tmp_path)
    conf = dict(qwen3_file(), name="no-arch")
    del conf["arch"]
    _testcell.add_config(tmp_path, conf)
    cell = _testcell.add_cell(tmp_path, "no-arch", "tiny-filter")
    b = _testcell.bench(tmp_path)
    with pytest.raises(KeyError, match="names no"):
        b.arch(b.workload(cell)["config"])


# ---------------------------------------------------------------------------
# a mixture of experts added by files
# ---------------------------------------------------------------------------

MOE = {
    "name": "tinymoe-a2.7b", "model_id": "qwen2-moe-a2.7b", "arch": "tinymoe",
    "source": "https://huggingface.co/Qwen/Qwen1.5-MoE-A2.7B/blob/main/"
              "config.json",
    # the published model; a smoke run reads the same keys off the smoke
    # model, served in this type
    "model": {"num_layers": 24, "d_model": 2048, "num_heads": 16,
              "num_kv_heads": 16, "head_dim": 128, "d_ff": 1408,
              "vocab_size": 151936, "qk_norm": False, "use_bias": False,
              "rope_theta": 1000000.0, "norm_eps": 1e-06,
              "tie_embeddings": False, "dtype": "float32",
              "moe": {"num_experts": 60, "num_experts_per_tok": 4,
                      "expert_d_ff": 1408, "num_shared_experts": 4,
                      "shared_d_ff": 5632, "padded_num_experts": 64}},
    "engine": {"slots": 4, "max_seq": 256},
}
# fp32 on the CPU, 8 rows a run: the sound reads 1.1e-7 to 2.5e-7 over 12
# seeds, the reference without its shared expert 0.22 to 0.49, the fp8
# control 0.084 to 0.11
MOE_LIMITS = {"score_gap": 2e-6, "rows_wrong": 0.0}
SHARED = '            y = y + self._swiglu(h, w, "moe.shared")\n'


def moe_bench(tmp_path, source=None):
    """A copy of the benchmark with the MoE architecture, its configuration
    and a tiny cell added; returns (bench, cell)."""
    src = (spec.HERE / "_testarch_moe.py").read_text()
    assert SHARED in src
    _testcell.copy_bench(tmp_path)
    _testcell.add_arch(tmp_path, "tinymoe", src if source is None
                       else source(src))
    _testcell.add_config(tmp_path, MOE)
    cell = _testcell.add_cell(tmp_path, MOE["name"], "tiny-filter",
                              limits=MOE_LIMITS, check_rows=8)
    return _testcell.bench(tmp_path), cell


def test_smoke_model_reads_the_files_keys(tmp_path):
    b, cell = moe_bench(tmp_path)
    eng, model = harness.build_engine(b.config_file(MOE["name"]), "cpu",
                                      smoke=True)
    assert set(model) == set(MOE["model"])
    assert set(model["moe"]) == set(MOE["model"]["moe"])
    assert model["moe"]["num_experts_per_tok"] == \
        eng.cfg.moe.num_experts_per_tok
    assert model["dtype"] == "float32" and eng.cfg.dtype == "float32"
    assert harness.check_config(eng.cfg, model) == []


def test_a_nested_key_that_departs_is_refused_at_setup(tmp_path,
                                                       monkeypatch):
    """The file says top-4 where the port's model (here its smoke model,
    served as the full one) routes top-2: set-up stops and names it."""
    from repro_torch.configs import base
    smoke = base.get_smoke_config("qwen2-moe-a2.7b")
    monkeypatch.setattr(base, "get_config", lambda arch: smoke)
    b, cell = moe_bench(tmp_path)
    conf = dict(MOE, model=harness.model_dict(smoke, MOE["model"]))
    assert conf["model"]["moe"]["num_experts_per_tok"] == 2
    conf["model"]["moe"]["num_experts_per_tok"] = 3
    _testcell.add_config(tmp_path, conf)
    with pytest.raises(SystemExit) as e:
        harness.Setup(b, cell, device="cpu", smoke=False, trace=False)
    msg = str(e.value)
    assert "moe.num_experts_per_tok: file 3, program 2" in msg
    assert msg.count(": file ") == 1


def test_an_moe_arch_added_by_files_runs(tmp_path):
    b, cell = moe_bench(tmp_path)
    assert spec.problems(b.doc) == []
    for trace in (False, True):
        out = harness.run_cell(cell, 11, 1.0, trace, bench=b, device="cpu",
                               smoke=True, t_start=time.perf_counter())
        assert out["failed"] == 0 and out["attempted"] >= 2
        assert out["correct"] is True, out["checks"]
        assert out["checks"]["score_gap"]["limit"] == 2e-6
        if not trace:
            assert set(out["metrics"]) == {"rows_per_s", "setup_s"}


def test_an_moe_reference_without_its_shared_expert_fails(tmp_path):
    b, cell = moe_bench(tmp_path, lambda src: src.replace(
        SHARED, "            pass\n"))
    out = harness.run_cell(cell, 11, 1.0, False, bench=b, device="cpu",
                           smoke=True, t_start=time.perf_counter())
    assert out["failed"] == 0
    assert out["checks"]["score_gap"]["value"] > 100 * 2e-6
    assert out["correct"] is False
