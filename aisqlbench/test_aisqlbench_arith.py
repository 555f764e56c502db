"""Metric arithmetic on synthetic timelines, against hand counts: the
drain rule, a percentile, unions and idle share, and the FLOP count (of
the qwen3 architecture, ``archs/qwen3.py``)."""
import importlib.util
import types

import pytest

from aisqlbench import devtrace, spec, timeline

M = spec.HERE / "metrics"
QWEN3 = spec.load_arch("qwen3")


def reader(name):
    s = importlib.util.spec_from_file_location(name, M / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def q(start, end, rows, ok=True):
    return {"start": start, "end": end, "rows": rows, "ok": ok}


def test_drain_rule_counts_all_work_over_all_time():
    # window opens at 10; the last query, in flight at the close, ends at 19
    qs = [q(10, 12, 4), q(12, 15, 4), q(10.5, 19, 4), q(11, 13, 4, ok=False)]
    assert timeline.rows_per_s(qs, 10.0) == pytest.approx(12 / 9)
    run = types.SimpleNamespace(queries=qs, t0=10.0)
    assert reader("rows_per_s")(run) == pytest.approx(12 / 9)


def test_nearest_rank():
    assert timeline.nearest_rank([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.9) == 9
    assert timeline.nearest_rank(list(range(100, 0, -1)), 0.9) == 90
    assert timeline.nearest_rank([3.0, 1.0, 2.0], 0.5) == 2.0


def test_union_overlap_and_busy_share():
    iv = [(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]
    assert timeline.union(iv) == [(0, 2), (3, 4)]
    assert timeline.length(iv) == 3
    assert timeline.overlap(1, 3.5, timeline.union(iv)) == pytest.approx(1.5)
    run = types.SimpleNamespace(t0=0.0, t1=10.0,
                                dispatches=[(0, 1, 4), (0.5, 2, 8), (3, 4, 2)])
    assert reader("engine_busy_share.batch")(run) == pytest.approx(30.0)
    assert reader("rows_per_dispatch.batch")(run) == pytest.approx(14 / 3)


def test_idle_share_and_gaps():
    ms = 1_000_000
    ev = [("k1", 0, 2 * ms), ("k2", 1 * ms, 2 * ms), ("k3", 6 * ms, 1 * ms)]
    clipped = devtrace.clip(ev, 0, 10 * ms)
    assert devtrace.busy_s(clipped) == pytest.approx(0.004)
    run = types.SimpleNamespace(events=clipped, window_ns=(0, 10 * ms))
    assert reader("idle_share.batch")(run) == pytest.approx(60.0)
    # gaps 3-6 ms and 7-10 ms; the host was in a prefill step over 2-5 ms
    gaps = devtrace.idle_gaps(clipped, [("prefill step", [(2 * ms, 5 * ms)])],
                              0, 10 * ms)
    assert gaps == [["prefill step", pytest.approx(0.003)],
                    ["outside the engine", pytest.approx(0.003)]]
    assert devtrace.top_ops(clipped)[2] == ["k3", pytest.approx(0.001)]


def test_flops_by_hand():
    m = {"d_model": 4, "head_dim": 2, "num_heads": 2, "num_kv_heads": 1,
         "d_ff": 8, "num_layers": 3, "vocab_size": 10}
    # q, o: 4 x 4; k, v: 4 x 2; mlp: 3 x 4 x 8
    assert QWEN3.matmul_params(m) == 2 * 16 + 2 * 8 + 96
    # a chunk of 3 tokens at positions 4, 5, 6: keys 5 + 6 + 7 = 18, and
    # the prompt ends there: 1 logits position
    want = 2 * 144 * 3 * 3 + 4 * 2 * 2 * 18 * 3 + 2 * 4 * 10
    assert QWEN3.step_flops(m, 4, 3, 1) == want
    # a prompt of 7 taken in by chunks of 3, 3 and 1 is the same work as
    # the 7 tokens at once, with the one logits position at the end
    steps = [("prefill", 0, 1, 3, QWEN3.step_flops(m, 0, 3, 0)),
             ("prefill", 1, 2, 3, QWEN3.step_flops(m, 3, 3, 0)),
             ("prefill", 2, 3, 1, QWEN3.step_flops(m, 6, 1, 1))]
    whole = (2 * 144 * 7 * 3 + 4 * 2 * 2 * 28 * 3 + 2 * 4 * 10)
    assert timeline.window_flops(steps, 0, 3) == whole
    assert QWEN3.step_flops(m, 0, 7, 1) == whole
    # half of the first step lies in [0.5, 3]
    assert timeline.window_flops(steps, 0.5, 3) == pytest.approx(
        whole - steps[0][4] / 2)


def test_mfu_and_step_readers():
    run = types.SimpleNamespace(
        window_ns=(0, 2e9), clock_window=(10.0, 12.0),
        steps=[("prefill", 10.0, 11.0, 8, 989e12)],
        model={"dtype": "bfloat16"})
    assert reader("mfu.batch")(run) == pytest.approx(50.0)
    run = types.SimpleNamespace(steps=[("prefill", 0, 0.1, 100, 0),
                                       ("prefill", 1, 1.3, 300, 0),
                                       ("prefill", 2, 2.6, 600, 0)])
    assert reader("prefill_ms_per_ktok.batch")(run) == pytest.approx(1000.0)
    assert reader("prefill_ms_per_ktok.batch")(
        types.SimpleNamespace(steps=[])) is None
