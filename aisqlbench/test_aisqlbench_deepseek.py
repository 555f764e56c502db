"""The DeepSeek-V3 architecture (``archs/deepseek_v3.py``) and the two
readers written for its cell, on the CPU, over the port's Moonlight-16B-A3B smoke model in
fp32 (the configuration file's keys read off it).

* ``groups()`` fills the port's parameter tree, leaf for leaf, in its
  types; the full model's groups are 15.96 B parameters.
* ``check_config`` stops set-up on a nested key that departs.
* SCORE through the batcher matches the reference within ``LIMITS`` with
  ``correct`` true, and a greedy COMPLETE's logits, step by step, match
  the reference's within ``DECODE_TOL``; the check fails where the
  reference leaves out the correction bias, the shared experts or the
  RoPE of k_pe.
* ``mla_attn_roofline.batch`` and ``moe_roofline.batch`` read seeded span
  sets as hand counts do, at most 100 %, and None without the spans.
"""
import dataclasses
import importlib.util
import json
import time

import pytest
import torch

from aisqlbench import _testcell, harness, spec, tokens, weights

ARCH = spec.load_arch("deepseek_v3")
NAME = "moonlight-16b-a3b"
CONF = spec.Bench().config_file(NAME)
# fp32 on the CPU, 8 rows a run over 12 seeds: the sound reference reads
# 2.4e-7 to 5.6e-7; without the correction bias 0.099 to 0.46, without
# the shared experts 0.12 to 0.31, without k_pe's RoPE 0.18 to 0.51
LIMITS = {"score_gap": 2e-6, "rows_wrong": 0.0}
DECODE_TOL = 1e-5       # the logits of a greedy decode, fp32 (read ~1e-6)
BROKEN = {
    "correction bias": ('choice = s + w["moe.router.bias"][:n] '
                        'if mo["correction_bias"] else s', 'choice = s'),
    "shared experts": ('            y = y + self._swiglu(h, w, "moe.shared")'
                       '\n', '            pass\n'),
    "k_pe RoPE": ('k_pe = _rope_pairs(kv[lo:hi, r:], pos, m["rope_theta"])',
                  'k_pe = kv[lo:hi, r:]'),
}


def conf_f32():
    conf = dict(json.loads(json.dumps(CONF)), name="moonlight-f32")
    conf["model"] = dict(conf["model"], dtype="float32")
    conf["engine"] = {"slots": 4, "max_seq": 256}
    return conf


def cell_bench(tmp_path, edit=None):
    _testcell.copy_bench(tmp_path)
    if edit is not None:
        src = (spec.HERE / "archs" / "deepseek_v3.py").read_text()
        assert edit[0] in src
        _testcell.add_arch(tmp_path, "deepseek_v3", src.replace(*edit))
    conf = conf_f32()
    _testcell.add_config(tmp_path, conf)
    cell = _testcell.add_cell(tmp_path, conf["name"], "tiny-filter",
                              limits=LIMITS, check_rows=8)
    return _testcell.bench(tmp_path), cell


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_groups_fill_the_ports_tree():
    eng, model = harness.build_engine(conf_f32(), "cpu", smoke=True)
    assert harness.check_config(eng.cfg, model) == []
    tree = dict(_paths(eng.params))
    drawn = {name: (shape, dt) for _, leaves in ARCH.groups(model)
             for name, shape, _, _, dt in leaves}
    assert set(drawn) == set(tree)
    for name, (shape, dt) in drawn.items():
        assert tree[name].shape == shape
        assert tree[name].dtype == (torch.float32 if dt == "model"
                                    else weights.DTYPES[dt])
    assert str(tree["layers.1.moe.router.bias"].dtype) == "torch.float32"
    harness.fill_weights(eng.params, ARCH, model, 7, "cpu")
    full = CONF["model"]
    n = sum(torch.Size(s).numel() for _, leaves in ARCH.groups(full)
            for _, s, *_ in leaves)
    assert round(n / 1e9, 2) == 15.96


def test_a_departing_nested_key_stops_setup(tmp_path, monkeypatch):
    from repro_torch.configs import base
    smoke = base.get_smoke_config(NAME)
    monkeypatch.setattr(base, "get_config", lambda arch: smoke)
    b, cell = cell_bench(tmp_path)
    conf = conf_f32()
    conf["model"] = harness.model_dict(smoke, conf["model"])
    conf["model"]["moe"]["routed_scale"] = 2.5
    conf["model"]["dtype"] = smoke.dtype
    _testcell.add_config(tmp_path, conf)
    with pytest.raises(SystemExit) as e:
        harness.Setup(b, cell, device="cpu", smoke=False, trace=False)
    assert "moe.routed_scale: file 2.5, program 2.446" in str(e.value)
    assert str(e.value).count(": file ") == 1


def test_score_through_the_batcher_matches_the_reference(tmp_path):
    b, cell = cell_bench(tmp_path)
    assert spec.problems(b.doc) == []
    for trace in (False, True):
        out = harness.run_cell(cell, 2**31 + 5, 1.0, trace, bench=b,
                               device="cpu", smoke=True,
                               t_start=time.perf_counter())
        assert out["failed"] == 0 and out["attempted"] >= 2
        assert out["correct"] is True, out["checks"]


def test_greedy_decode_matches_the_reference():
    """A COMPLETE of 5 tokens: the logits of its prefill's last chunk (at
    the prompt's last position) and of each decode step, tapped on the batcher's head, against the
    reference over the prompt and the tokens chosen."""
    eng, model = harness.build_engine(conf_f32(), "cpu", smoke=True)
    harness.fill_weights(eng.params, ARCH, model, 3, "cpu")
    from repro_torch.inference.backend import COMPLETE, Request
    b = eng._batcher
    seen = []
    head = b.model.logits_of

    def tap(params, h):
        out = head(params, h)
        seen.append(out[0].clone())
        return out

    b.model = dataclasses.replace(b.model, logits_of=tap)
    prompt = "Does this contract contain an indemnification clause? ab c"
    eng.submit_batch([Request(prompt, eng.arch, COMPLETE, max_tokens=5)])
    assert len(seen) == 2 + 4        # two prefill chunks, four steps
    seen = seen[1:]
    ids = tokens.encode(prompt)
    chosen = [int(t.argmax()) for t in seen]
    ref = ARCH.Reference(model, 3, "cpu").run(
        [ids + chosen[:-1]], [list(range(len(ids) - 1, len(ids) + 4))])[0]
    assert (torch.stack(seen) - ref).abs().max().item() < DECODE_TOL


@pytest.mark.parametrize("left_out", sorted(BROKEN))
def test_a_reference_that_leaves_out_a_part_fails(tmp_path, left_out):
    b, cell = cell_bench(tmp_path, BROKEN[left_out])
    out = harness.run_cell(cell, 2**31 + 5, 1.0, False, bench=b,
                           device="cpu", smoke=True,
                           t_start=time.perf_counter())
    assert out["failed"] == 0
    assert out["checks"]["score_gap"]["value"] > 1000 * LIMITS["score_gap"]
    assert out["correct"] is False


# ---------------------------------------------------------------------------
# the two readers on seeded span sets
# ---------------------------------------------------------------------------

def reader(name):
    path = spec.HERE / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def node(span_kind, t0, t1, children=(), **attrs):
    return {"name": span_kind, "kind": span_kind, "t0": t0, "t1": t1,
            "attrs": attrs, "events": [], "children": list(children)}


def seeded_run(seed, monkeypatch, *, device=True):
    """A traced run over three waves of prefill steps whose layer spans
    take ``slow`` x their least time; returns (run, the hand counts of
    the two shares)."""
    g = torch.Generator().manual_seed(seed)
    model = CONF["model"]
    lay = model["num_layers"]
    want = {"attn": [0.0, 0.0], "moe": [0.0, 0.0]}
    waves, t, prev = [], 100.0, None
    for n in range(3):
        steps, w0 = [], t
        for _ in range(4):
            rows = [[int(torch.randint(0, 8000, (), generator=g)),
                     int(torch.randint(1, 33, (), generator=g)), 0]
                    for _ in range(int(torch.randint(1, 17, (),
                                                     generator=g)))]
            ntok = sum(c for _, c, _ in rows)
            kids = []
            for i in range(lay):
                slow = 1.0 + 3.0 * float(torch.rand((), generator=g))
                a = ARCH.attn_bound_s(model, rows)
                kids.append(node("layer.attn", t, t, **(
                    {"device_ms": 1e3 * a * slow} if device else {})))
                want["attn"][0] += a
                want["attn"][1] += a * slow
                f = {}
                if i >= model["first_k_dense"]:
                    hit = int(torch.randint(1, 65, (), generator=g))
                    m = ARCH.moe_bound_s(model, ntok, hit)
                    f = dict(experts_hit=hit, max_expert_tokens=ntok)
                    want["moe"][0] += m
                    want["moe"][1] += m * slow
                    if device:
                        f["device_ms"] = 1e3 * m * slow
                elif device:
                    f["device_ms"] = 5.0
                kids.append(node("layer.ffn", t, t, **f))
            steps.append(node("engine.step", t, t + 0.1, [
                node("step.forward", t, t + 0.09, kids)],
                kind="prefill", rows=len(rows), tokens=ntok, nb=8,
                rows_at=rows))
            t += 0.1
        waves.append(node("engine.wave", w0, t, steps, engine_id="e#0",
                          wave=n + 1, requests=16, prev_wave_end=prev))
        prev = t
        t += 0.01
    from aisqlbench import spans
    monkeypatch.setattr(spans, "waves", lambda: waves)
    run = harness.Run(NAME + ".seeded", CONF, model, {}, 100.0, t, 1.0,
                      [], [], [])
    run.clock_window = (100.0, prev)          # the last wave's end
    return run, {k: 100.0 * a / b for k, (a, b) in want.items()}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_roofline_readers_on_seeded_spans(seed, monkeypatch):
    run, want = seeded_run(seed, monkeypatch)
    got = {"attn": reader("mla_attn_roofline.batch")(run),
           "moe": reader("moe_roofline.batch")(run)}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9)
        assert 25.0 <= got[k] <= 100.0
    run, _ = seeded_run(seed, monkeypatch, device=False)    # the CPU
    assert reader("mla_attn_roofline.batch")(run) is None
    assert reader("moe_roofline.batch")(run) is None


def test_the_readers_read_none_for_a_dense_model(monkeypatch):
    run, _ = seeded_run(4, monkeypatch)
    from aisqlbench import spans
    for w in spans.waves():
        for s in w["children"]:
            s["children"][0]["children"] = []      # no layer spans
    assert reader("mla_attn_roofline.batch")(run) is None
    assert reader("moe_roofline.batch")(run) is None
    run.conf = json.loads(json.dumps(spec.Bench().config_file("qwen3-32b")))
    assert reader("moe_roofline.batch")(run) is None
