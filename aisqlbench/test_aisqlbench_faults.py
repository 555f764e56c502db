"""The check fails a broken timed path: a run skips the look for a card
(CPU, smoke models, a tiny cell added by files) and is driven whole, with
the program broken underneath, once for each fault a filter cell can have:
a step that leaves its state (the paged KV pool) unchanged, and a SCORE
altered where it is produced.  The limits are set as a cell's are: above
the sound readings of one seed, and a sound run of another seed passes
them.  (Half a batch left out and the exchange between cards are faults
of training and of several cards: this cell has neither.)"""
import time

import pytest

from aisqlbench import _testcell, harness


def run(tmp_path, cell, seed, limits):
    b = _testcell.bench(tmp_path)
    return harness.run_cell(cell, seed, 1.0, False, bench=b, device="cpu",
                            smoke=True, t_start=time.perf_counter(),
                            limits=limits)


def limits_from(*outs):
    """Four times the largest sound reading of each gap, and no less than
    0.02, four times the rounding of the smoke models' logits in bf16;
    counts exact."""
    return {k: (0.0 if k == "rows_wrong"
                else max(4 * max(o["checks"][k]["value"] for o in outs),
                         0.02))
            for k in outs[0]["checks"] if k != "failed"}


def sound(tmp_path, cell):
    """Limits from two seeds, and a run of a third within them."""
    lim = limits_from(run(tmp_path, cell, 101, {}),
                      run(tmp_path, cell, 303, {}))
    out = run(tmp_path, cell, 202, lim)
    assert out["correct"] is True, (lim, out["checks"])
    return lim


def skip_scatter(self, pool, *a, **k):
    return pool


def shifted_yes(orig):
    def fn(self, *a):
        logits, lens = orig(self, *a)
        from repro_torch.inference import tokenizer
        logits = logits.clone()
        logits[:, tokenizer.YES_ID] += 3.0
        return logits, lens
    return fn


@pytest.fixture
def filter_cell(tmp_path):
    _testcell.copy_bench(tmp_path)
    return _testcell.add_cell(tmp_path, "qwen3-32b", "tiny-filter")


def test_filter_faults(tmp_path, filter_cell, monkeypatch):
    from repro_torch.inference import continuous, paged_kv
    lim = sound(tmp_path, filter_cell)
    with monkeypatch.context() as m:
        m.setattr(paged_kv.PagedKVCache, "scatter", skip_scatter)
        assert run(tmp_path, filter_cell, 202, lim)["correct"] is False
    with monkeypatch.context() as m:
        m.setattr(continuous.ContinuousBatcher, "_prefill_fn",
                  shifted_yes(continuous.ContinuousBatcher._prefill_fn))
        out = run(tmp_path, filter_cell, 202, lim)
        assert out["checks"]["score_gap"]["value"] > lim["score_gap"]
        assert out["correct"] is False
