"""The traffic generator: deterministic for a seed, the mixes' medians,
clips, tenants, rows a query and pool sizes."""
import json

import numpy as np
import pytest

from aisqlbench import spec, traffic

from aisqlbench._testcell import TINY_MIXES

MIXES = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))


def mix(name):
    if name in TINY_MIXES:
        return TINY_MIXES[name]
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES + sorted(TINY_MIXES))
def test_same_seed_same_traffic(name):
    a = traffic.generate(mix(name), 2**31 + 7, 10)
    b = traffic.generate(mix(name), 2**31 + 7, 10)
    c = traffic.generate(mix(name), 2**31 + 8, 10)
    assert json.dumps(a.tables) == json.dumps(b.tables)
    assert [q.sql for q in a.warmup] == [q.sql for q in b.warmup]
    assert json.dumps(a.tables) != json.dumps(c.tables)
    # another seed: other bytes, the same sizes in the same order
    for t in a.pools:
        assert [[len(x) for x in q.bodies] for q in a.pools[t]] == [
            [len(x) for x in q.bodies] for q in c.pools[t]]


@pytest.mark.parametrize("name", MIXES + sorted(TINY_MIXES))
def test_lengths_median_clip_and_strata(name):
    m = mix(name)
    bb = m["body_bytes"]
    q = traffic.quantile_lengths(bb, traffic.STRATUM)
    assert q.min() >= bb["lo"] and q.max() == bb["hi"]
    assert abs(np.median(q) - bb["median"]) / bb["median"] < 0.05
    tr = traffic.generate(m, 5, 10)
    queries = [q for p in tr.pools.values() for q in p]
    lens = [len(b) for q in queries for b in q.bodies]
    assert min(lens) >= bb["lo"] and max(lens) <= bb["hi"]
    # any whole stratum of a tenant holds the same sizes, in some order, and
    # each of its queries one size from every band
    k = m["rows_per_query"][0]
    bands = {int(x): i // (traffic.STRATUM // k) for i, x in enumerate(q)}
    for pool in tr.pools.values():
        first = [len(b) for q_ in pool for b in q_.bodies][:traffic.STRATUM]
        assert sorted(first) == sorted(q.tolist())
        for j in range(0, traffic.STRATUM, k):
            assert sorted(bands[x] for x in first[j:j + k]) == list(
                range(k)) or k == traffic.STRATUM


@pytest.mark.parametrize("name", MIXES + sorted(TINY_MIXES))
def test_tenants_rows_and_operators(name):
    m = mix(name)
    tr = traffic.generate(m, 11, 10)
    queries = [q for p in tr.pools.values() for q in p]
    assert {q.tenant for q in queries} <= set(traffic.tenants_of(m))
    assert {len(q.ids) for q in queries} <= set(m["rows_per_query"])
    assert len(tr.warmup) == 1
    assert [len(b) for b in tr.warmup[0].bodies] == [m["body_bytes"]["lo"]]
    # no row is read twice: every query has a table of its own
    names = [q.table for q in queries + tr.warmup]
    assert len(set(names)) == len(names)
    bodies = [b for q in queries for b in q.bodies]
    assert len(set(bodies)) == len(bodies)
    for q in queries:
        assert q.table in q.sql and "AI_FILTER" in q.sql
    assert traffic.check_fits(m, 2048) is None


@pytest.mark.parametrize("name", MIXES + sorted(TINY_MIXES))
def test_pool_covers_the_window(name):
    m = mix(name)
    tr = traffic.generate(m, 3, 20)
    per = int(np.ceil(m["pool_rows_per_s"] * 20
                      / (m["tenants"] * np.mean(m["rows_per_query"])))) + 1
    assert {len(p) for p in tr.pools.values()} == {per}
    assert sorted(tr.pools) == traffic.tenants_of(m)


def test_a_query_of_one_tenant_does_the_same_work_each_time():
    """filter-batch: one tenant, 16 rows a query, one of every band, so
    every query of every seed carries the same sizes in the same order."""
    m = mix("filter-batch")
    sizes = {tuple(len(b) for b in q.bodies)
             for seed in (1, 2**31 + 99)
             for q in traffic.generate(m, seed, 10).pools["tenant0"]}
    assert len(sizes) == 1
    assert list(next(iter(sizes))) == traffic.quantile_lengths(
        m["body_bytes"], traffic.STRATUM).tolist()


def test_other_loops_and_operators_are_refused():
    with pytest.raises(ValueError):
        traffic.generate(dict(mix("filter-batch"), loop="open"), 1, 10)
    with pytest.raises(ValueError):
        traffic.sql_of(dict(mix("filter-batch"), operator="complete"), "t")
