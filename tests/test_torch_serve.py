"""The port's HTTP service, NL2SQL and serving entry point
(``repro_torch.serve``, ``repro_torch.launch.serve``) held to the JAX
package's, on the CPU.

Over each package's simulated client every answer is a pure function of
(seed, model, kind, prompt), so nothing may differ: the error contract,
streamed and buffered rows, NDJSON event kinds, the SQL NL2SQL compiles,
the 422 body, the wire report, concurrent rows and billing, and the span
names of a trace.  Over fp32 smoke engines with the port's params bridged
from the JAX engines', a cascade filter, a CLASSIFY and a COMPLETE sent
through the port's HTTP server give the JAX ``AisqlEngine``'s rows, calls
and credits, with every SCORE within VALUE_TOL, and NL2SQL rejects the
same SQL (greedy fp32 decoding gives the same tokens).
"""
import contextlib
import dataclasses
import json
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.configs.base as jcfgs  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.data.datasets as jD  # noqa: E402
import repro.inference.api as japi  # noqa: E402
import repro.launch.serve as jlaunch  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro.serve.http as jhttp  # noqa: E402
import repro.tables.table as jtable  # noqa: E402
import repro_torch.configs.base as tcfgs  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data.datasets as tD  # noqa: E402
import repro_torch.inference.api as tapi  # noqa: E402
import repro_torch.launch.serve as tlaunch  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
import repro_torch.serve.http as thttp  # noqa: E402
import repro_torch.tables.table as ttable  # noqa: E402
from repro.inference.engine import JaxInferenceEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.inference.backend import SCORE  # noqa: E402
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from test_http import STREAM_QUERIES  # noqa: E402

SEED = 7                            # tests/test_http.py's
VALUE_TOL = 1e-5                    # SCORE, fp32 (test_torch_aisql_engines)
PAIR = ("proxy-8b", "oracle-70b")

JAX = types.SimpleNamespace(
    core=jcore, D=jD, api=japi, serve=jserve, http=jhttp, obs=jobs,
    Table=jtable.Table, engine_kw={})
TORCH = types.SimpleNamespace(
    core=tcore, D=tD, api=tapi, serve=tserve, http=thttp, obs=tobs,
    Table=ttable.Table, engine_kw={"device": "cpu"})


def _small_catalog(P, n=160):
    """tests/test_http.py's catalog, built by package ``P``."""
    rng = np.random.default_rng(SEED)
    return P.core.Catalog({"t": P.Table({
        "id": np.arange(n),
        "score": rng.random(n),
        "text": [f"row {i} text" for i in range(n)],
        "_truth": rng.random(n) < 0.5,
        "_difficulty": np.full(n, 0.05),
    }, name="t")})


def _serving(P, cat, *, tenants=None, workers=4, executor=None):
    executor = executor or P.core.ExecConfig(partitioned=True,
                                             partition_rows=32)
    return P.core.ServingEngine.simulated(
        cat, seed=SEED, tenants=tenants,
        cfg=P.core.ServingConfig(workers=workers, executor=executor),
        **P.engine_kw)


@contextlib.contextmanager
def _service(P, cat, **kw):
    """A simulated ``ServingEngine`` behind ``P``'s HTTP server; yields
    (engine, server)."""
    nl2sql = kw.pop("nl2sql", None)
    cfg = kw.pop("http", None)
    with _serving(P, cat, **kw) as eng, P.serve.AisqlHttpServer(
            eng, nl2sql=nl2sql, cfg=cfg) as srv:
        yield eng, srv


def _client(P, srv, **kw):
    return P.serve.AisqlHttpClient(srv.host, srv.port, **kw)


def _default_model(P, cat):
    """tests/test_http.py's semantic model."""
    VQ = P.serve.VerifiedQuery
    model = P.serve.SemanticModel.from_catalog(cat)
    model.verified = [
        VQ("high", "list the ids with score above one half",
           "SELECT id, score FROM t WHERE score > 0.5"),
        VQ("count", "count all rows", "SELECT COUNT(*) FROM t"),
        VQ("low", "list the ids with tiny scores",
           "SELECT id FROM t WHERE score < 0.1"),
    ]
    return model


def _status_error(P, fn):
    with pytest.raises(P.http.HttpStatusError) as exc:
        fn()
    return exc.value.status, exc.value.body


# ---------------------------------------------------------------------------
# the wire contract
# ---------------------------------------------------------------------------


def _mapped_errors(P):
    """``error_for`` over one instance of each library failure."""
    from importlib import import_module
    pkg = P.core.__name__.split(".")[0]
    cost = import_module(f"{pkg}.core.cost")
    pipeline = import_module(f"{pkg}.inference.pipeline")
    try:
        P.core.parse("SELECT id FROM t LIMIT x")
    except P.core.ParseError as e:
        parse_err = e
    excs = [
        parse_err,
        P.serve.NL2SQLError("q", 2, "SELECT ghost FROM t",
                            P.serve.SemanticValidationError("ghost")),
        P.serve.SemanticValidationError("unknown table 'x'"),
        P.core.AdmissionError("tenant 'a' exhausted its credit budget"),
        pipeline.RequestFailed("retries exhausted"),
        cost.UnknownTableError("nope", {"t": None}),
        TimeoutError("slow"),
        RuntimeError("ServingEngine is closed"),
        KeyError("internal_state_key"),
        P.http.HttpError("not_found", "unknown endpoint '/v1/x'"),
    ]
    out = []
    for e in excs:
        err = P.http.error_for(e)
        out.append((err.status, err.code, err.body(), err.retry_after_s))
    return out


def test_error_contract_matches_jax():
    assert thttp.ERROR_CONTRACT == jhttp.ERROR_CONTRACT
    assert list(thttp.ERROR_CONTRACT) == list(jhttp.ERROR_CONTRACT)
    assert _mapped_errors(TORCH) == _mapped_errors(JAX)


def test_error_statuses_over_the_wire_match_jax():
    """400 with a caret, 401 for a bad token, 404, unknown table."""
    def observe(P):
        cat = _small_catalog(P)
        out = []
        with _service(P, cat, http=P.serve.HttpConfig(
                tokens={"good": "acme"})) as (_, srv):
            for token in (None, "bad"):
                out.append(_status_error(P, lambda: _client(
                    P, srv, token=token).query("SELECT id FROM t")))
            good = _client(P, srv, token="good")
            for sql in ("SELECT id FROM t LIMIT x", "SELECT id FROM nope",
                        "SELECT id FROM t WHERE\n"):
                out.append(_status_error(P, lambda: good.query(sql)))
            out.append(_status_error(
                P, lambda: good._request("GET", "/v1/nope").read()))
        return out
    j, t = observe(JAX), observe(TORCH)
    assert t == j
    assert [s for s, _ in t] == [401, 401, 400, 400, 400, 404]
    assert t[2][1]["error"]["caret"].splitlines()[1].index("^") == 23


def test_a_tensor_in_a_result_is_a_500():
    """The port's one change to the wire: a tensor cell is an engine
    fault, not the text "tensor(...)" under a 200."""
    with pytest.raises(TypeError, match="torch.Tensor"):
        thttp._py(torch.zeros(2))
    with pytest.raises(TypeError, match="torch.Tensor"):
        thttp._dumps({"rows": [[1, torch.ones(())]]})
    assert thttp._py(np.float32(0.5)) == 0.5
    assert thttp._py(np.arange(2)) == [0, 1]
    cells = np.empty(2, dtype=object)
    cells[0], cells[1] = torch.zeros(1), torch.ones(1)
    cat = tcore.Catalog({"x": ttable.Table({"id": np.arange(2), "v": cells},
                                           name="x")})
    with _service(TORCH, cat) as (_, srv):
        status, body = _status_error(
            TORCH, lambda: _client(TORCH, srv).query("SELECT v FROM x"))
        assert _client(TORCH, srv).query("SELECT id FROM x")["rows"] == \
            [[0], [1]]
    assert status == 500 and body["error"]["code"] == "internal"
    assert "torch.Tensor" in body["error"]["message"]


# ---------------------------------------------------------------------------
# streamed and buffered rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sql", STREAM_QUERIES)
def test_streamed_and_buffered_rows_match_jax(sql):
    def observe(P):
        with _service(P, _small_catalog(P)) as (_, srv):
            client = _client(P, srv)
            events = list(client.query_stream(sql))
            buffered = client.query(sql)
        rows = [e["values"] for e in events if e["kind"] == "row"]
        assert rows == buffered["rows"]
        assert events[0]["columns"] == buffered["columns"]
        assert events[-1]["row_count"] == buffered["row_count"] == len(rows)
        return ([e["kind"] for e in events], events[0]["columns"], rows,
                buffered["columns"], buffered["row_count"],
                buffered["stats"]["ai_calls"],
                buffered["stats"]["ai_credits"])
    assert observe(TORCH) == observe(JAX)


# ---------------------------------------------------------------------------
# NL2SQL
# ---------------------------------------------------------------------------


def test_nl2sql_compiles_the_corpus_as_jax_does():
    def observe(P):
        cat = _small_catalog(P)
        model = _default_model(P, cat)
        op = P.serve.NL2SQLOperator(
            model, cat, P.api.make_simulated_client(seed=SEED),
            max_attempts=3)
        sqls = [op.compile(q)
                for q, _ in P.serve.question_corpus(model, 20, seed=1)]
        with _service(P, cat, nl2sql=op) as (_, srv):
            client = _client(P, srv)
            executed = client.nl2sql("count all rows", execute=True)
            served = client.semantic_model()
        return sqls, op.compiled, op.rejected_attempts, executed, served
    j, t = observe(JAX), observe(TORCH)
    assert t == j
    assert t[1] == 21 and t[3]["rows"] == [[160]]


def test_nl2sql_rejection_body_matches_jax():
    def observe(P):
        cat = _small_catalog(P)
        broken = P.serve.SemanticModel.from_catalog(cat)
        broken.verified = [P.serve.VerifiedQuery(
            "bad", "show the ghost data", "SELECT ghost FROM t")]
        op = P.serve.NL2SQLOperator(
            broken, cat, P.api.make_simulated_client(seed=SEED),
            max_attempts=2, validate_model=False)
        with _service(P, cat, nl2sql=op) as (_, srv):
            out = _status_error(P, lambda: _client(P, srv).nl2sql(
                "show the ghost data"))
        return out + (op.rejected_attempts, op.failed)
    j, t = observe(JAX), observe(TORCH)
    assert t == j
    status, body, rejected, failed = t
    assert status == 422 and body["error"]["code"] == "nl2sql_rejected"
    assert body["error"]["rejected_sql"] == "SELECT ghost FROM t"
    assert (rejected, failed) == (2, 1)


# ---------------------------------------------------------------------------
# reports, concurrency, billing, traces
# ---------------------------------------------------------------------------


def _untimed(report):
    """A wire report without its clock readings (the keys in seconds)."""
    if isinstance(report, dict):
        return {k: _untimed(v) for k, v in report.items()
                if not k.endswith("_s")}
    return report


def test_wire_report_matches_library_and_jax():
    tokens = {"tok-a": "alpha", "tok-b": "beta"}

    def observe(P):
        with _service(P, _small_catalog(P),
                      http=P.serve.HttpConfig(tokens=tokens)) as (eng, srv):
            for tok, sqls in (("tok-a", STREAM_QUERIES[:2]),
                              ("tok-b", STREAM_QUERIES[2:])):
                client = _client(P, srv, token=tok)
                for sql in sqls:
                    client.query(sql)
            eng.drain()
            wire = _client(P, srv, token="tok-a").report()
            lib = eng.report()
        assert wire == json.loads(P.http._dumps(dataclasses.asdict(lib)))
        return _untimed(wire)
    j, t = observe(JAX), observe(TORCH)
    assert t == j
    assert {n: r["completed"] for n, r in t["tenants"].items()} == \
        {"alpha": 2, "beta": 2}


def _tenant_queries(P):
    cat = P.core.Catalog({
        "articles": P.D.skewed_articles(160, seed=3),
        "reviews": P.D.cascade_table("IMDB", rows=160, seed=1)})
    return cat, {
        "alpha": ["SELECT a.id FROM articles a WHERE "
                  "AI_FILTER(PROMPT('broad topic? {0}', a.headline))",
                  "SELECT a.id, a.headline FROM articles a WHERE a.id < 40"],
        "beta": ["SELECT r.id FROM reviews r WHERE "
                 "AI_FILTER(PROMPT('positive? {0}', r.text))",
                 "SELECT AI_CLASSIFY(PROMPT('topic {0}', a.headline), "
                 "['politics','sports','tech']) AS topic, COUNT(*) AS n "
                 "FROM articles a GROUP BY topic"],
    }


def _billing(wire):
    """{(tenant, field): value} of each tenant's meter."""
    return {(t, k): r[k] for t, r in wire["tenants"].items()
            for k in ("queries", "completed", "failed", "credits_spent",
                      "dispatched_calls")}


def test_concurrent_tenants_match_serial_and_jax():
    """Four workers, two tenants: the rows of each query, sent at once by
    both tenants, are the rows sent one at a time; the tenant meters sum
    to the dispatch spend and the backends' meter, in both packages."""
    def run(P, concurrent):
        cat, work = _tenant_queries(P)
        tokens = {f"tok-{t}": t for t in work}
        rows, errors = {}, []
        with _service(P, cat, http=P.serve.HttpConfig(tokens=tokens)) \
                as (eng, srv):
            def drive(tenant):
                client = _client(P, srv, token=f"tok-{tenant}")
                try:
                    for sql in work[tenant]:
                        rows[(tenant, sql)] = client.query(sql)["rows"]
                except Exception as e:       # surfaced after the join
                    errors.append((tenant, e))
            threads = [threading.Thread(target=drive, args=(t,))
                       for t in work]
            for th in threads:
                th.start()
                if not concurrent:
                    th.join(timeout=60)
            for th in threads:
                th.join(timeout=60)
                assert not th.is_alive()
            assert not errors, errors
            eng.drain()
            wire = _client(P, srv, token="tok-alpha").report()
        total = sum(r["credits_spent"] for r in wire["tenants"].values())
        assert total == pytest.approx(wire["total_credits"], rel=1e-12)
        assert wire["total_credits"] == pytest.approx(
            wire["backend_credits"], rel=1e-12)
        assert wire["retries"] == wire["failed_requests"] == 0
        return rows, _billing(wire)
    serial = {}
    for name, P in (("jax", JAX), ("torch", TORCH)):
        serial[name] = run(P, False)
        rows, billing = run(P, True)
        assert rows == serial[name][0]
        assert billing == pytest.approx(serial[name][1], rel=1e-12)
    assert serial["torch"][0] == serial["jax"][0]
    assert serial["torch"][1] == pytest.approx(serial["jax"][1], rel=1e-12)


def _span_names(tree):
    return [tree["name"]] + [n for c in tree["children"]
                             for n in _span_names(c)]


def test_trace_spans_and_metrics_match_jax():
    sql = ("SELECT r.id FROM reviews AS r WHERE "
           "AI_FILTER(PROMPT('positive? {0}', r.text))")

    def observe(P):
        cat = P.core.Catalog({"reviews": P.D.cascade_table("IMDB", rows=40)})
        with _service(P, cat, workers=2,
                      executor=P.core.ExecConfig()) as (_, srv):
            client = _client(P, srv)
            out = client.query(sql)
            trace = client.trace(out["query_id"])
            metrics = P.obs.parse_prometheus_text(client.metrics())
            missing = _status_error(P, lambda: client.trace("q999999"))
        assert trace["query_id"] == out["query_id"]
        return _span_names(trace["trace"]), sorted(metrics), missing[0]
    j, t = observe(JAX), observe(TORCH)
    assert t == j
    assert {"query", "parse", "optimize", "execute", "pipeline.dispatch",
            "dispatch.replica"} <= set(t[0])
    assert t[2] == 404


# ---------------------------------------------------------------------------
# over fp32 smoke engines with bridged params
# ---------------------------------------------------------------------------


def _fp32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


@pytest.fixture(scope="module")
def engines():
    """{arch: (JAX engine, port engine)} with the port's params bridged."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcfgs, "get_smoke_config", _fp32(jcfgs.get_smoke_config))
    mp.setattr(tcfgs, "get_smoke_config", _fp32(tcfgs.get_smoke_config))
    try:
        out = {}
        for i, arch in enumerate(PAIR):
            kw = dict(smoke=True, max_batch=4, max_seq=128, seed=3 + i)
            jeng = JaxInferenceEngine(arch, **kw)
            teng = TorchInferenceEngine(arch, device="cpu", **kw)
            teng.params = bridge.params_from_jax(
                teng.cfg, jax.tree.map(np.asarray, jeng.params))
            out[arch] = (jeng, teng)
    finally:
        mp.undo()
    return out


ENGINE_QUERIES = [
    ("filter_cascade",
     "SELECT r.id, r.text FROM reviews AS r WHERE "
     "AI_FILTER(PROMPT('positive? {0}', r.text))"),
    ("classify",
     "SELECT r.id, AI_CLASSIFY(PROMPT('sentiment of {0}', r.text), "
     "['positive','negative','neutral']) AS s FROM reviews AS r "
     "WHERE r.id < 8"),
    ("complete",
     "SELECT r.id, AI_COMPLETE(PROMPT('summarize: {0}', r.text), "
     "max_tokens => 4) AS c FROM reviews AS r LIMIT 4"),
]
QUESTION = "how many reviews are positive?"


def _engine_cfg(P):
    return dict(
        catalog=P.core.Catalog({"reviews": P.D.cascade_table("IMDB",
                                                             rows=16)}),
        executor=P.core.ExecConfig(use_cascade=True,
                                   cascade=P.core.CascadeConfig(seed=0)))


@contextlib.contextmanager
def _scores(backends):
    """Each SCORE the backends serve, by (model, prompt)."""
    scores = {}
    for be in backends:
        real = be.submit_batch

        def spy(reqs, real=real):
            out = real(reqs)
            for r, res in zip(reqs, out):
                if r.kind == SCORE:
                    scores[(res.model, r.prompt)] = res.score
            return out
        be.submit_batch = spy
    try:
        yield scores
    finally:
        for be in backends:
            del be.submit_batch


def _jax_reference(backends):
    """The queries through the JAX ``AisqlEngine`` with the client a
    ``ServingEngine`` session builds, and the NL2SQL rejection."""
    cfg = _engine_cfg(JAX)
    sched = japi.Scheduler()
    for be in backends:
        sched.register(be)
    client = japi.CortexClient(
        sched, default_model="oracle-70b", proxy_model="proxy-8b",
        pipeline=japi.PipelineConfig(cache_ttl_s=300.0))
    eng = jcore.AisqlEngine(cfg["catalog"], client,
                            executor=cfg["executor"])
    out = {}
    with _scores(backends) as scores:
        for name, sql in ENGINE_QUERIES:
            table = eng.sql(sql)
            _, rows = jhttp.table_rows(table)
            rep = eng.last_report
            taus = [(c.stats.tau_low, c.stats.tau_high)
                    for c in eng.cascades.values()]
            out[name] = (list(table.column_names), rows, rep.ai_calls,
                         rep.ai_credits, taus)
    op = jserve.NL2SQLOperator(
        jserve.SemanticModel.from_catalog(cfg["catalog"]), cfg["catalog"],
        japi.CortexClient(sched), max_attempts=2)
    with pytest.raises(jserve.NL2SQLError) as exc:
        op.compile(QUESTION)
    return out, dict(scores), exc.value.last_sql


def _port_over_http(backends):
    cfg = _engine_cfg(TORCH)
    sched = tapi.Scheduler()
    for be in backends:
        sched.register(be)
    op = tserve.NL2SQLOperator(
        tserve.SemanticModel.from_catalog(cfg["catalog"]), cfg["catalog"],
        tapi.CortexClient(sched), max_attempts=2)
    serving = tcore.ServingEngine(
        cfg["catalog"], sched, device="cpu",
        cfg=tcore.ServingConfig(workers=4, executor=cfg["executor"]),
        tenants={"alpha": tcore.TenantPolicy(),
                 "beta": tcore.TenantPolicy()})
    out = {}
    with _scores(backends) as scores, serving, tserve.AisqlHttpServer(
            serving, nl2sql=op, cfg=tserve.HttpConfig(
                tokens={"tok-a": "alpha", "tok-b": "beta"})) as srv:
        for i, (name, sql) in enumerate(ENGINE_QUERIES):
            client = _client(TORCH, srv, token=("tok-a", "tok-b")[i % 2])
            got = client.query(sql)
            out[name] = (got["columns"], got["rows"],
                         got["stats"]["ai_calls"],
                         got["stats"]["ai_credits"])
        status, body = _status_error(
            TORCH, lambda: _client(TORCH, srv, token="tok-a").nl2sql(
                QUESTION))
        serving.drain()
        report = serving.report()
    assert status == 422 and body["error"]["code"] == "nl2sql_rejected"
    assert report.retries == report.failed_requests == 0
    tenants = sum(t.credits_spent for t in report.tenants.values())
    assert tenants == pytest.approx(report.total_credits, rel=1e-12)
    assert tenants == pytest.approx(sum(
        out[n][3] for n, _ in ENGINE_QUERIES), rel=1e-12)
    return out, dict(scores), body["error"]["rejected_sql"], op


def test_http_over_engines_matches_jax(engines):
    j, j_scores, j_sql = _jax_reference([engines[a][0] for a in PAIR])
    t, t_scores, t_sql, op = _port_over_http([engines[a][1] for a in PAIR])
    for name, _ in ENGINE_QUERIES:
        cols, jrows, calls, credits, taus = j[name]
        assert t[name][0] == cols and t[name][2] == calls > 0, name
        assert t[name][3] == pytest.approx(credits, rel=1e-12), name
        trows = [tuple(r) for r in t[name][1]]
        jrows = [tuple(r) for r in jrows]
        if name != "filter_cascade":
            assert trows == jrows, name
            continue
        # a filter row may differ only where a JAX SCORE of it lies
        # within VALUE_TOL of a threshold it was held to
        thresholds = [0.5] + [x for pair in taus for x in pair]
        for row in set(trows) ^ set(jrows):
            margin = min(abs(s - x) for (_, p), s in j_scores.items()
                         if row[1] in p for x in thresholds)
            print(f"flipped filter row {row[0]}: JAX margin {margin}")
            assert margin <= VALUE_TOL
    assert {m for m, _ in t_scores} == set(PAIR)
    assert set(t_scores) == set(j_scores)
    assert max(abs(t_scores[k] - j_scores[k]) for k in j_scores) <= VALUE_TOL
    # two COMPLETEs of 128 tokens on the oracle, both rejected alike
    assert op.client.calls_by_model == {"oracle-70b": 2}
    assert op.rejected_attempts == 2
    assert t_sql == j_sql and t_sql is not None


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_launch_serve_explains_as_jax_does(capsys):
    args = ["--archs", "proxy-8b", "--rows", "24", "--cascade", "--explain",
            "--sql", "SELECT r.id FROM reviews AS r WHERE AI_FILTER("
            "PROMPT('positive? {0}', r.text)) AND r.id < 20 LIMIT 3"]
    assert jlaunch.main(args) == 0
    j = capsys.readouterr().out
    assert tlaunch.main(["--device", "cpu"] + args) == 0
    t = capsys.readouterr().out
    assert t == j
    assert "Limit 3" in t and "AI] (2 conjuncts)" in t


def test_launch_serve_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--archs", "proxy-8b", "--explain"])


def test_import_guard_covers_the_service():
    import tests.test_torch_engine as te
    root = te.ROOT
    scanned = {p.relative_to(root).as_posix() for p in te._sources()}
    modules = [f"src/repro_torch/serve/{m}.py"
               for m in ("__init__", "semantic_model", "http")]
    modules += ["src/repro_torch/launch/__init__.py",
                "src/repro_torch/launch/serve.py"]
    assert set(modules) <= scanned
    for m in modules:
        src = (root / m).read_text()
        assert "import jax" not in src and "from repro." not in src, m
