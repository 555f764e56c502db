"""The control, at a size a test run holds: the reference in fp8, put in
the program's place, is judged as the program is and comes out not
correct.  On the card the same readings at each cell's own size set the
limits (``control.py``); here the smoke models of a tiny cell: a limit
between the program's widest reading over three seeds and the control's
least passes every program run and fails every control run."""
import math

from aisqlbench import _testcell, control, judge


def test_control_fails(tmp_path):
    _testcell.copy_bench(tmp_path)
    cell = _testcell.add_cell(tmp_path, "qwen3-32b", "tiny-filter")
    lines = control.readings(cell, [1, 2, 3], {1, 2, 3}, 1.0, device="cpu",
                             smoke=True, bench=_testcell.bench(tmp_path))
    gaps = [k for k in lines[0]["control"]]
    limits = {}
    separated = []
    for k in gaps:
        lo = max(l["program"][k] for l in lines)
        hi = min(l["control"][k] for l in lines)
        if hi >= 3 * lo:
            separated.append(k)
            limits[k] = math.sqrt(max(lo, 1e-6) * hi)
        else:
            limits[k] = judge.BIG
    assert separated
    # the gap; the exact count (rows_wrong) takes the limit 0 with a tie of
    # the gap's limit, which the fault tests hold
    for l in lines:
        program = {k: l["program"][k] for k in gaps}
        assert judge.verdict(program, limits) is True
        assert judge.verdict(l["control"], limits) is False
