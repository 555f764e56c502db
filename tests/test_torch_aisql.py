"""The port's SQL layer (``repro_torch.core``, ``tables``, ``data``) held to
the JAX package's, on the CPU over each package's simulated client.

The queries of the JAX package's own system, streaming and index tests
run through both ``AisqlEngine``s with the same seeds.  Every simulated
answer is a pure function of (seed, model, kind, prompt), so nothing may
differ: column names and values, ``last_report.ai_calls`` and credits,
the optimizer's trace and plan, and each cascade's ``CascadeStats``.
The port's columnar tables, spill manager, dataset generators and
multi-tenant ``ServingEngine`` are held to the JAX ones the same way.
"""
import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.data.datasets as jD  # noqa: E402
import repro.inference.api as japi  # noqa: E402
import repro.tables.chunked as jchunked  # noqa: E402
import repro.tables.spill as jspill  # noqa: E402
import repro.tables.table as jtable  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data.datasets as tD  # noqa: E402
import repro_torch.inference.api as tapi  # noqa: E402
import repro_torch.tables.chunked as tchunked  # noqa: E402
import repro_torch.tables.spill as tspill  # noqa: E402
import repro_torch.tables.table as ttable  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX = types.SimpleNamespace(
    core=jcore, D=jD, api=japi, Table=jtable.Table, FileRef=jtable.FileRef,
    ChunkedTable=jchunked.ChunkedTable, SpillManager=jspill.SpillManager,
    engine_kw={}, semindex=jcore.SemIndexConfig(impl="reference"))
# the port's manager on the CPU: its "auto" impl takes the plain top-k
TORCH = types.SimpleNamespace(
    core=tcore, D=tD, api=tapi, Table=ttable.Table, FileRef=ttable.FileRef,
    ChunkedTable=tchunked.ChunkedTable, SpillManager=tspill.SpillManager,
    engine_kw={"device": "cpu"}, semindex=tcore.SemIndexConfig())


def _value(v):
    """A column value as plain Python, comparable across the packages."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, dataclasses.astuple(v))
    if isinstance(v, (list, tuple)):
        return tuple(_value(x) for x in v)
    if isinstance(v, np.ndarray):
        return tuple(_value(x) for x in v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    return v


def _rows(table):
    cols = list(table.column_names)
    return cols, [tuple(_value(table.column(c)[i]) for c in cols)
                  for i in range(table.num_rows)]


# ---------------------------------------------------------------------------
# the queries (tests/test_system.py, test_streaming.py, test_semindex.py)
# ---------------------------------------------------------------------------


def _engine(P, cat, **kw):
    return P.core.AisqlEngine(cat, P.api.make_simulated_client(),
                              **P.engine_kw, **kw)


def _paper_example(P):
    papers, images = P.D.papers_tables(n_papers=60, images_per_paper=3)
    cat = P.core.Catalog({"papers": papers, "paper_images": images})
    return _engine(P, cat), """
        SELECT AI_SUMMARIZE_AGG(p.abstract)
        FROM papers p JOIN paper_images i ON p.id = i.id
        WHERE p.date BETWEEN 2010 AND 2015 AND
        AI_FILTER(PROMPT('Abstract {0} discusses energy efficiency', p.abstract))
        AND AI_FILTER(PROMPT('Image {0} shows TPC-H results', i.image_file))
    """


def _plan(mode):
    def case(P):
        papers, images = P.D.papers_tables(n_papers=80, images_per_paper=4)
        cat = P.core.Catalog({"papers": papers, "paper_images": images})
        eng = _engine(P, cat, optimizer=P.core.OptimizerConfig(mode=mode))
        return eng, """
            SELECT COUNT(*)
            FROM papers p JOIN paper_images i ON p.id = i.id
            WHERE p.date BETWEEN 2005 AND 2015 AND
            AI_FILTER(PROMPT('Abstract {0} discusses energy', p.abstract)) AND
            AI_FILTER(PROMPT('Image {0} shows TPC-H', i.image_file))
        """
    return case


def _cascade(P):
    cat = P.core.Catalog({"ds": P.D.cascade_table("NQ", rows=300)})
    eng = _engine(P, cat, executor=P.core.ExecConfig(
        use_cascade=True, cascade=P.core.CascadeConfig(seed=0)))
    return eng, ("SELECT * FROM ds AS d WHERE "
                 "AI_FILTER(PROMPT('answers? {0}', d.text))")


def _join_rewrite(P):
    left, right, _ = P.D.join_tables("NASDAQ")
    cat = P.core.Catalog({"l": left, "r": right})
    return _engine(P, cat), (
        "SELECT * FROM l JOIN r ON AI_FILTER(PROMPT("
        f"'{P.D.JOIN_PROMPTS['NASDAQ']}', l.content, r.label))")


def _classify_groupby(P):
    cat = P.core.Catalog({"reviews": P.D.cascade_table("SST2", rows=60)})
    return _engine(P, cat), (
        "SELECT AI_CLASSIFY(PROMPT('sentiment of {0}', r.text), "
        "['positive','negative']) AS sentiment, COUNT(*) "
        "FROM reviews AS r GROUP BY sentiment")


def _aggregates(P):
    cat = P.core.Catalog({"articles": P.D.nyt_articles(40)})
    return _engine(P, cat), (
        "SELECT a.category, AI_AGG(a.body, 'Which topics recur?') AS themes, "
        "AI_SUMMARIZE_AGG(a.body) AS summary FROM articles AS a "
        "GROUP BY a.category")


def _text_catalog(P, n=90):
    rng = np.random.default_rng(0)
    words = ["database engine", "vector index", "soccer match",
             "film review"]
    return P.core.Catalog({"t": P.Table({
        "id": np.arange(n),
        "val": rng.random(n),
        "text": [f"[t:{i}] {words[i % 4]} body {i}" for i in range(n)],
    }, name="t")})


def _similarity_topk(P):
    eng = _engine(P, _text_catalog(P), semindex=P.semindex)
    return eng, ("SELECT t.id FROM t "
                 "ORDER BY AI_SIMILARITY(t.text, 'database engine') DESC "
                 "LIMIT 7")


def _partitioned_limit(P):
    n = 256
    t = P.Table({
        "id": np.arange(n),
        "text": [f"[t:{i}] row text {i}" for i in range(n)],
        "_truth": np.arange(n) % 2 == 0,
        "_difficulty": np.full(n, 0.01),
    }, name="t")
    eng = _engine(P, P.core.Catalog({"t": t}), executor=P.core.ExecConfig(
        partitioned=True, partition_rows=32))
    return eng, ("SELECT * FROM t WHERE "
                 "AI_FILTER(PROMPT('keep this row? {0}', t.text)) LIMIT 12")


QUERIES = {
    "paper_example": _paper_example,
    "plan_a_pushdown": _plan("always_pushdown"),
    "plan_b_ai_aware": _plan("ai_aware"),
    "cascade_nq": _cascade,
    "join_rewrite_nasdaq": _join_rewrite,
    "classify_groupby": _classify_groupby,
    "ai_agg_summarize_agg": _aggregates,
    "similarity_topk_index": _similarity_topk,
    "partitioned_filter_limit": _partitioned_limit,
}


def _observe(P, name):
    eng, sql = QUERIES[name](P)
    out = eng.sql(sql)
    rep = eng.last_report
    return {
        "rows": _rows(out),
        "ai_calls": rep.ai_calls,
        "ai_credits": rep.ai_credits,
        "calls_by_model": dict(eng.client.calls_by_model),
        "trace": list(eng.opt.trace),
        "plan": rep.plan,
        "reoptimizations": list(rep.reoptimizations),
        "partitions": rep.partitions,
        "semindex": rep.semindex,
        "cascades": {k: dataclasses.asdict(c.stats)
                     for k, c in eng.cascades.items()},
    }


@pytest.mark.parametrize("name", list(QUERIES))
def test_sql_matches_jax_over_simulator(name):
    j = _observe(JAX, name)
    t = _observe(TORCH, name)
    assert t == j
    assert t["ai_calls"] > 0 and t["rows"][1]
    if name == "cascade_nq":
        stats = next(iter(t["cascades"].values()))
        assert stats["rows"] == 300 and stats["oracle_calls"] > 0
    if name == "join_rewrite_nasdaq":
        assert t["ai_calls"] == 100                  # O(L), not O(L * R)
    if name == "similarity_topk_index":
        assert t["semindex"]["index_topk"] == 1


def test_explain_and_reports_match_jax():
    """EXPLAIN's text, the per-operator estimated-vs-actual reports and
    the pilot sample agree across the packages (the cascade query)."""
    out = {}
    for tag, P in (("jax", JAX), ("torch", TORCH)):
        eng, sql = _cascade(P)
        plan = eng.explain(sql)
        eng.sql(sql)
        rep = eng.last_report
        out[tag] = (plan, [dataclasses.asdict(o) for o in rep.operators],
                    rep.pilot)
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# tables: ChunkedTable with spilling, against the JAX package's
# ---------------------------------------------------------------------------


def _columns(P, rng, n_rows, col_types):
    cols, types_ = {}, {}
    for i, t in enumerate(col_types):
        name = f"c{i}_{t}"
        types_[name] = t
        if t == "int":
            cols[name] = rng.integers(-5, 6, n_rows)
        elif t == "float":
            cols[name] = rng.random(n_rows)
        elif t == "bool":
            cols[name] = rng.random(n_rows) < 0.5
        elif t == "file":
            cols[name] = [P.FileRef(f"s3://b/{int(k)}.png", "image/png")
                          for k in rng.integers(0, 4, n_rows)]
        else:
            cols[name] = [f"w{int(k)} body" for k in rng.integers(0, 7,
                                                                  n_rows)]
    return cols, types_


def _spill_run(P, seed, n_rows, chunk_rows, col_types, budget):
    """Gathers, a filter, a join and a group-by over a budgeted
    ChunkedTable; returns what they gave and the spill counters."""
    rng = np.random.default_rng(seed)
    cols, types_ = _columns(P, rng, n_rows, col_types)
    spill = P.SpillManager(budget_bytes=budget)
    ct = P.ChunkedTable(cols, types_, name="t", chunk_rows=chunk_rows,
                        spill=spill)
    after_build = spill.stats()
    idx = rng.integers(0, n_rows, size=n_rows)
    gathers = {c: _value(ct.gather(c, idx)) for c in ct.column_names}
    mask = rng.random(n_rows) < 0.5
    filtered = _rows(ct.filter_mask(mask))
    taken = _rows(ct.take(np.arange(n_rows - 1, -1, -1)))
    groups = {_value(k): _value(v)
              for k, v in ct.group_indices(ct.column_names[0]).items()}
    summary = [(ct.ndv(c), ct.avg_len(c)) for c in ct.column_names]
    return {"build": after_build, "gathers": gathers, "filtered": filtered,
            "taken": taken, "groups": groups, "summary": summary,
            "stats": spill.stats()}


@pytest.mark.parametrize("seed,n_rows,chunk_rows,col_types,budget", [
    (1, 20, 1, ("int", "str", "float"), 600),     # the recorded example
    (7, 64, 5, ("int", "str", "float"), 600),
    (3, 100, 16, ("int", "float", "str", "bool", "file"), 2000),
    (11, 40, 40, ("str", "int"), None),
])
def test_chunked_spill_matches_jax(seed, n_rows, chunk_rows, col_types,
                                   budget):
    """The port's reload count is held to the JAX package's on the same
    inputs (on the recorded example both give 0 reloads after a spill,
    which ``tests/test_storage.py`` asserts against)."""
    j = _spill_run(JAX, seed, n_rows, chunk_rows, col_types, budget)
    t = _spill_run(TORCH, seed, n_rows, chunk_rows, col_types, budget)
    assert t == j
    if budget is not None:
        assert t["stats"]["spill_events"] > 0


def test_table_ops_match_jax():
    out = {}
    for tag, P in (("jax", JAX), ("torch", TORCH)):
        rng = np.random.default_rng(5)
        cols, types_ = _columns(P, rng, 30, ("int", "str", "float", "file"))
        a = P.Table(cols, types_, name="a")
        b = P.Table({"k": np.arange(-5, 6),
                     "w": [f"v{i}" for i in range(11)]}, name="b")
        groups = a.group_indices("c1_str")
        out[tag] = (
            _rows(a.filter_mask(a.column("c0_int") > 0)),
            _rows(a.take(np.arange(29, -1, -3))),
            _rows(a.with_column("extra", np.arange(30)).head(7)),
            _rows(a.concat_rows(a).prefixed("x")),
            _rows(a.hash_join(b, "c0_int", "k")),
            _rows(a.select(["c1_str", "c3_file"]).rename({"c1_str": "s"})),
            {_value(k): _value(v) for k, v in groups.items()},
            [(a.ndv(c), a.avg_len(c)) for c in a.column_names])
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# datasets: every generator, two seeds
# ---------------------------------------------------------------------------


def _datasets(P, seed):
    D = P.D
    yield "cascade", {name: _rows(D.cascade_table(name, rows=25, seed=seed))
                      for name in D.CASCADE_DATASETS}
    for name in D.JOIN_DATASETS:
        left, right, spec = D.join_tables(name, seed=seed)
        yield f"join {name}", (_rows(left), _rows(right),
                               dataclasses.asdict(spec),
                               sorted(D.true_pairs_of(left, right)))
    yield "nyt", _rows(D.nyt_articles(50, seed=seed))
    yield "skewed", _rows(D.skewed_articles(60, seed=seed))
    yield "nyt pair", tuple(_rows(t) for t in D.nyt_join_pair(30, seed=seed))
    yield "papers", tuple(_rows(t) for t in D.papers_tables(
        20, images_per_paper=2, seed=seed))


@pytest.mark.parametrize("seed", [0, 3])
def test_datasets_match_jax(seed):
    j = dict(_datasets(JAX, seed))
    t = dict(_datasets(TORCH, seed))
    assert list(t) == list(j)
    for key in j:
        assert t[key] == j[key], key
    rng = np.random.default_rng(seed)
    pred, truth = rng.random(40) < 0.5, rng.random(40) < 0.4
    assert tD.binary_metrics(pred, truth) == jD.binary_metrics(pred, truth)
    pairs, true = {(1, "a"), (2, "b")}, {(1, "a"), (3, "c")}
    assert tD.pair_metrics(pairs, true) == jD.pair_metrics(pairs, true)
    assert tD.prf1(3, 1, 2) == jD.prf1(3, 1, 2)


# ---------------------------------------------------------------------------
# ServingEngine: two tenants over the simulator
# ---------------------------------------------------------------------------


def _serve(P):
    cat = P.core.Catalog({
        "reviews": P.D.cascade_table("IMDB", rows=80),
        "articles": P.D.nyt_articles(40)})
    cfg = P.core.ServingConfig(workers=2)
    out = []
    with P.core.ServingEngine.simulated(cat, seed=0, cfg=cfg,
                                        **P.engine_kw) as srv:
        for tenant, sql in (
                ("tenant-a", "SELECT * FROM reviews AS r WHERE "
                             "AI_FILTER(PROMPT('positive? {0}', r.text))"),
                ("tenant-b", "SELECT AI_CLASSIFY(PROMPT('topic {0}', a.body),"
                             " ['politics','sports','tech']) AS topic, "
                             "COUNT(*) FROM articles AS a GROUP BY topic")):
            ticket = srv.submit(tenant, sql)
            table = ticket.result(timeout=60)
            srv.drain()
            rep = ticket.report
            out.append((tenant, _rows(table), rep.ai_calls, rep.ai_credits,
                        rep.plan, list(rep.optimizer_trace)))
        report = srv.report()
        out.append({name: (t.completed, t.credits_spent, t.dispatched_calls)
                    for name, t in report.tenants.items()})
    return out


def test_serving_engine_matches_jax():
    j = _serve(JAX)
    t = _serve(TORCH)
    assert t == j
    assert all(q[2] > 0 for q in t[:2])


# ---------------------------------------------------------------------------
# device contract and the import guard's reach
# ---------------------------------------------------------------------------


def test_semindex_defaults_to_cuda():
    cat = _text_catalog(TORCH, 8)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    for make in (
            lambda: tcore.AisqlEngine(cat, tapi.make_simulated_client(),
                                      semindex=True),
            lambda: tcore.AisqlEngine(cat, tapi.make_simulated_client(),
                                      semindex=tcore.SemIndexConfig()),
            lambda: tcore.ServingEngine.simulated(cat, semindex=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    eng = tcore.AisqlEngine(cat, tapi.make_simulated_client(), semindex=True,
                            device="cpu")
    assert eng.semindex.device.type == "cpu"
    assert tcore.AisqlEngine(cat, tapi.make_simulated_client()).semindex \
        is None                              # no index, no device asked


def test_import_guard_covers_the_sql_layer():
    import tests.test_torch_engine as te
    scanned = {p.relative_to(ROOT).as_posix() for p in te._sources()}
    modules = [f"src/repro_torch/core/{m}.py" for m in (
        "__init__", "aggregate", "cascade", "cost", "engine", "executor",
        "expr", "optimizer", "plan", "serving", "sqlparse", "stats")]
    modules += ["src/repro_torch/tables/table.py",
                "src/repro_torch/tables/chunked.py",
                "src/repro_torch/data/datasets.py",
                "src/repro_torch/configs/oracle_70b.py"]
    assert set(modules) <= scanned
    for m in modules:
        src = (ROOT / m).read_text()
        assert "import jax" not in src and "from repro." not in src, m
