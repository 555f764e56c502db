"""Serving driver: run AISQL queries against real PyTorch inference engines.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --archs proxy-8b oracle-70b --replicas 2 \
        --sql "SELECT * FROM reviews AS r WHERE AI_FILTER(...)"

Stands up the Cortex-platform analogue (engines + scheduler + API service)
on smoke-size models, loads the synthetic datasets into a catalog, and
executes queries end-to-end with AI-aware optimization.  The engines run
on the card; ``--device cpu`` runs them on the CPU instead.
"""
from __future__ import annotations

import argparse

from repro_torch.core import AisqlEngine, Catalog, CascadeConfig, ExecConfig
from repro_torch.data import datasets as D
from repro_torch.inference.api import make_engine_client
from repro_torch.tables.table import Table


DEFAULT_SQL = ("SELECT * FROM reviews AS r WHERE "
               "AI_FILTER(PROMPT('positive review? {0}', r.text)) LIMIT 5")


def build_catalog(rows: int = 64) -> Catalog:
    tables = {
        "reviews": D.cascade_table("IMDB", rows=rows),
        "articles": D.nyt_articles(rows),
    }
    left, right, _ = D.join_tables("AGNEWS_100")
    tables["news"] = left
    tables["topics"] = right
    return Catalog(tables)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=["proxy-8b", "oracle-70b"])
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--rows", type=int, default=48)
    ap.add_argument("--cascade", action="store_true")
    ap.add_argument("--sql", default=DEFAULT_SQL)
    ap.add_argument("--explain", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (no fallback: without "
                         "CUDA, pass cpu)")
    args = ap.parse_args(argv)

    client = make_engine_client(tuple(args.archs), replicas=args.replicas,
                                device=args.device)
    engine = AisqlEngine(
        build_catalog(args.rows), client,
        executor=ExecConfig(use_cascade=args.cascade,
                            cascade=CascadeConfig(batch_size=32,
                                                  min_samples=8)))
    if args.explain:
        print(engine.explain(args.sql))
        return 0
    out = engine.sql(args.sql)
    print(out)
    for i in range(min(out.num_rows, 10)):
        print(" ", {k: str(v)[:60] for k, v in out.row(i).items()})
    rep = engine.last_report
    print(f"-- {rep.ai_calls} LLM calls, {rep.ai_credits:.6f} credits, "
          f"{rep.wall_seconds:.2f}s wall")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
