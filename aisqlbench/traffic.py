"""The one traffic generator: tables of documents and the AISQL queries
over them, made from a mix file (``traffic/<name>.json``), ``--seed`` and
``--seconds``.

A mix says what its queries look like:

``loop``                "closed": each tenant submits its next query when
                        the last returns
``tenants``, ``workers`` tenants, and the service's worker threads
``operator``            "filter": AI_FILTER in WHERE
``prompt``              the PROMPT template, ``{0}`` standing for the row
``rows_per_query``      the choices of rows a query, drawn evenly
``body_bytes``          the log-normal length of a row: ``median``,
                        ``sigma`` (of the log), clipped to [``lo``, ``hi``]
``pool_rows_per_s``     rows the tenants' pools hold for each second of the
                        window, over all tenants; a run that exhausts it
                        fails rather than measuring less

Each query reads a table of its own (``docs_<stream>_<n>``), so no row is
read twice and no query's pilot sample reaches another's rows.  Rows are
printable ASCII, one byte a token for the byte-level tokenizer.  Lengths
are stratified: each run of ``STRATUM`` consecutive rows of a tenant takes
the mix's log-normal at ``STRATUM`` evenly spaced quantiles, dealt so that
each query of the run holds one from every band, in a fixed order: the
seed makes the bytes, not the sizes, so a run does the same work under
every seed.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Dict, List, Optional

import numpy as np

STRATUM = 16
ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)


@dataclasses.dataclass
class Query:
    tenant: str
    table: str
    sql: str
    ids: List[int]
    bodies: List[str]


@dataclasses.dataclass
class Traffic:
    mix: Dict[str, Any]
    tables: Dict[str, Dict[str, list]]
    warmup: List[Query]
    pools: Dict[str, List[Query]]       # each tenant's queries in order

    def prompt_of(self, body: str) -> str:
        return self.mix["prompt"].replace("{0}", body)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def quantile_lengths(spec: Dict[str, Any], n: int) -> np.ndarray:
    """The log-normal of ``spec`` at n evenly spaced quantiles, clipped."""
    nd = statistics.NormalDist()
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    q = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), spec["lo"], spec["hi"]).astype(np.int64)


def _text(rng: np.random.Generator, n: int) -> str:
    return ALPHABET[rng.integers(0, len(ALPHABET), n)].tobytes().decode()


def sql_of(mix: Dict[str, Any], table: str) -> str:
    if mix["operator"] != "filter":
        raise ValueError(f"unknown operator {mix['operator']!r}")
    return (f"SELECT d.id FROM {table} AS d "
            f"WHERE AI_FILTER(PROMPT('{mix['prompt']}', d.body))")


class _Maker:
    """Makes one stream's tables and queries."""

    def __init__(self, mix, seed: int, stream: int, tables):
        self.mix = mix
        self.rng = rng_for(seed, stream)
        self.stream = stream
        self.tables = tables
        self.n = 0
        self.lens: Dict[int, List[int]] = {}

    def lengths(self, ti: int, k: int) -> List[int]:
        """The next k lengths of tenant ``ti``'s stratum.  A stratum is
        dealt into groups of k that each take one quantile from every band
        of k (so the queries of a stratum carry near the same work); the
        groups come in an order rotated by the tenant's index.  The sizes
        and their order are the seed's to keep: a seed makes only the
        bytes, so every seed offers the same work."""
        left = self.lens.setdefault(ti, [])
        if len(left) < k:
            q = quantile_lengths(self.mix["body_bytes"], STRATUM).tolist()
            n = STRATUM // k if STRATUM % k == 0 else 1
            groups = [q[g::n] for g in range(n)]
            for g in range(n):
                left.extend(groups[(g + ti) % n][::(-1) ** (g + ti)])
        out, left[:] = left[:k], left[k:]
        return out

    def query(self, tenant: str, ti: int, lengths=None) -> Query:
        mix = self.mix
        if lengths is None:
            k = int(self.rng.choice(mix["rows_per_query"]))
            lengths = self.lengths(ti, k)
        name = f"docs_{self.stream}_{self.n}"
        ids = [self.n * 64 + j for j in range(len(lengths))]
        bodies = [_text(self.rng, int(n)) for n in lengths]
        self.n += 1
        self.tables[name] = {"id": ids, "body": bodies}
        return Query(tenant, name, sql_of(mix, name), ids, bodies)


def tenants_of(mix) -> List[str]:
    return [f"tenant{i}" for i in range(mix["tenants"])]


def generate(mix: Dict[str, Any], seed: int, seconds: float) -> Traffic:
    if mix["loop"] != "closed":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    tables: Dict[str, Dict[str, list]] = {}
    names = tenants_of(mix)
    # warm-up (stream 1): one query of one row at the short clip, which
    # starts what a first query starts (the service's threads, the
    # pipeline, the engine's first steps).  Eager PyTorch builds nothing
    # for a shape: after a warm-up that also ran the longest row, through
    # every gather width, the window's first query took no less time (on
    # an H100), and that warm-up cost every run 12 s
    warm = _Maker(mix, seed, 1, tables)
    warmup = [warm.query(names[0], 0, [mix["body_bytes"]["lo"]])]
    make = _Maker(mix, seed, 0, tables)
    mean_rows = float(np.mean(mix["rows_per_query"]))
    per = math.ceil(mix["pool_rows_per_s"] * seconds
                    / (len(names) * mean_rows)) + 1
    pools = {t: [make.query(t, ti) for _ in range(per)]
             for ti, t in enumerate(names)}
    return Traffic(mix, tables, warmup, pools)


def longest_prompt(mix: Dict[str, Any]) -> int:
    """Tokens of the longest prompt the mix can make (BOS included)."""
    return 1 + len(mix["prompt"].replace("{0}", "")) + mix["body_bytes"]["hi"]


def check_fits(mix: Dict[str, Any], max_seq: int) -> Optional[str]:
    need = longest_prompt(mix)
    if need > max_seq:
        return (f"the mix's longest request takes {need} positions, the "
                f"configuration serves {max_seq}")
    return None
