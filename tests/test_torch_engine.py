"""The port's engine end to end, held to ``JaxInferenceEngine``, and the
rule that the port imports neither JAX nor the JAX package.

One mixed request list (SCORE, COMPLETE with mid-stream admission,
CLASSIFY with labels, EMBED) is served by both engines, on both backends,
in fp32, with the port's params converted from the JAX engine's.  Token
ids, token counts, credits and labels must be identical; SCORE and EMBED
values agree within 1e-5 (fp32 summation order differs between the
frameworks, so bitwise equality is not the bar).
"""
import ast
import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.configs.base as jcfgs  # noqa: E402
import repro.inference.tokenizer as jtok  # noqa: E402
import repro_torch.configs.base as tcfgs  # noqa: E402
import repro_torch.inference.tokenizer as ttok  # noqa: E402
from repro.inference.engine import JaxInferenceEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED,  # noqa
                                           SCORE, Request)
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
VALUE_TOL = 1e-5


def _fp32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


def _requests():
    reqs = []
    for i in range(3):
        reqs.append(Request(f"is item {i} in stock?" + "!" * (9 * i),
                            "proxy-8b", SCORE, request_id=len(reqs) + 1))
    for i, mt in enumerate([9, 2, 5, 1, 7, 3]):
        reqs.append(Request(f"describe item {i} " + "w" * (5 * i),
                            "proxy-8b", COMPLETE, max_tokens=mt,
                            request_id=len(reqs) + 1))
    reqs.append(Request("which colour is the sky?", "proxy-8b", CLASSIFY,
                        labels=("red", "blue", "green"),
                        request_id=len(reqs) + 1))
    reqs.append(Request("pick any", "proxy-8b", CLASSIFY,
                        labels=("yes", "no"), multi_label=True,
                        request_id=len(reqs) + 1))
    for i, dim in enumerate([16, 64]):
        reqs.append(Request(f"embed text number {i}", "proxy-8b", EMBED,
                            metadata={"embed_dim": dim},
                            request_id=len(reqs) + 1))
    return reqs


def _serve(engine, reqs, tok_module, monkeypatch):
    """Results of ``engine`` plus the generated token ids, in the order the
    engine decoded them."""
    ids = []
    real = tok_module.decode

    def record(seq):
        ids.append(tuple(int(t) for t in seq))
        return real(seq)

    monkeypatch.setattr(tok_module, "decode", record)
    out = engine.submit_batch(copy.deepcopy(reqs))
    monkeypatch.setattr(tok_module, "decode", real)
    return out, ids


@pytest.mark.parametrize("backend", ["static", "continuous"])
def test_submit_batch_matches_jax(backend, monkeypatch):
    monkeypatch.setattr(jcfgs, "get_smoke_config",
                        _fp32(jcfgs.get_smoke_config))
    monkeypatch.setattr(tcfgs, "get_smoke_config",
                        _fp32(tcfgs.get_smoke_config))
    kw = dict(smoke=True, max_batch=4, max_seq=96, seed=3, backend=backend)
    jeng = JaxInferenceEngine("proxy-8b", **kw)
    teng = TorchInferenceEngine("proxy-8b", device="cpu", **kw)
    teng.params = bridge.params_from_jax(
        teng.cfg, jax.tree.map(np.asarray, jeng.params))
    reqs = _requests()
    jout, jids = _serve(jeng, reqs, jtok, monkeypatch)
    tout, tids = _serve(teng, reqs, ttok, monkeypatch)
    assert tids == jids and len(tids) == 6
    assert len(tout) == len(reqs)
    for r, j, t in zip(reqs, jout, tout):
        assert (t.request_id, t.kind, t.text, t.label, t.labels,
                t.tokens_in, t.tokens_out, t.credits) == \
            (j.request_id, j.kind, j.text, j.label, j.labels,
             j.tokens_in, j.tokens_out, j.credits), r
        if r.kind == SCORE:
            assert abs(t.score - j.score) <= VALUE_TOL
        if r.kind == EMBED:
            assert len(t.embedding) == r.metadata["embed_dim"]
            np.testing.assert_allclose(t.embedding, j.embedding,
                                       rtol=0, atol=VALUE_TOL)
    if backend == "continuous":
        ts, js = teng.backend_stats(), jeng.backend_stats()
        for key in ("admitted", "retired", "prefill_steps", "decode_steps",
                    "prefill_tokens", "decode_tokens", "kv_peak_blocks"):
            assert ts[key] == js[key], key
        assert ts["admitted"] == 9 > teng.max_batch   # mid-stream admission
        assert teng.capacity_hint() == 4 * teng.max_batch


def test_engine_contract_edges():
    eng = TorchInferenceEngine("proxy-8b", device="cpu", max_batch=2,
                               max_seq=64, failure_rate=1.0)
    from repro_torch.inference.backend import EngineFailure
    with pytest.raises(EngineFailure):
        eng.submit_batch([Request("x", "proxy-8b", SCORE, request_id=1)])
    eng.failure_rate = 0.0
    dup = [Request("a", "proxy-8b", SCORE, request_id=7),
           Request("b", "proxy-8b", EMBED, request_id=7),
           Request("c", "proxy-8b", CLASSIFY, request_id=8)]
    out = eng.submit_batch(dup)
    assert [r.kind for r in out] == [SCORE, EMBED, CLASSIFY]
    assert out[2].label is None and out[2].tokens_in > 0
    with pytest.raises(EngineFailure):
        eng._restore_order(dup[:1], out)
    assert eng.hosted_models() == ["proxy-8b"]
    assert eng.backend_stats()["backend"] == "continuous"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchInferenceEngine("proxy-8b")


# ---------------------------------------------------------------------------
# import guard
# ---------------------------------------------------------------------------


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_repro_imports_in_source():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(PKG.parent).with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(bad)); print(bad)\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.splitlines()[0] == "0", out.stdout
