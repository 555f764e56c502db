"""The port's semantic index held to the JAX package's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages.  K3's
plain version is held to the JAX ``ref.py`` and to the Pallas kernel run
in interpret mode: ids equal, values within 1e-5 (fp32 sums are taken in
another order by each library, and the shapes here hold no near-ties).
The sign-vector case makes every score an exact dyadic number, so ties
are everywhere and the ids must be equal with no margin at all.  The
index (k-means on the host in numpy) gives bitwise the JAX centroids and
cells; the manager gives the same rows and counters over each package's
simulated client.  The CUDA kernel itself is held to the plain version
on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.semindex as jsem  # noqa: E402
import repro_torch.semindex as tsem  # noqa: E402
from repro.inference.api import make_simulated_client as j_client  # noqa
from repro.kernels.similarity_topk.ops import \
    similarity_topk as j_topk  # noqa: E402
from repro_torch.inference.api import make_engine_client  # noqa: E402
from repro_torch.inference.api import make_simulated_client as t_client  # noqa
from repro_torch.kernels.similarity_topk import ops  # noqa: E402
from repro_torch.kernels.similarity_topk.ref import \
    similarity_topk_ref  # noqa: E402

VALUE_TOL = 1e-5
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(seed, shapes, dtype="float32"):
    """numpy normals rounded to ``dtype``, as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(JD[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TD[dtype]) for a in arrs])


def _check_same(t_out, j_out, exact_values=False):
    tv, ti = (x.numpy() for x in t_out)
    jv, ji = (np.asarray(x) for x in j_out)
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    if exact_values:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("Q,N,D,k,bq,bn", [
    (13, 201, 48, 5, 8, 64),      # the shapes of tests/test_kernels.py
    (32, 512, 64, 17, 16, 128),
    (1, 1000, 32, 1, 8, 256),
    (64, 64, 128, 64, 64, 64),    # k == N
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_topk_matches_jax(Q, N, D, k, bq, bn, dtype):
    (jq, jc), (tq, tc) = _pair(7, [(Q, D), (N, D)], dtype)
    got = ops.similarity_topk(tq, tc, k)         # CPU tensor: plain version
    _check_same(got, j_topk(jq, jc, k, impl="reference"))
    _check_same(got, j_topk(jq, jc, k, impl="interpret", block_q=bq,
                            block_n=bn))


def test_plain_topk_k_exceeds_corpus():
    (jq, jc), (tq, tc) = _pair(8, [(3, 16), (4, 16)])
    vals, idx = similarity_topk_ref(tq, tc, 7)
    _check_same((vals, idx), j_topk(jq, jc, 7, impl="interpret",
                                    block_q=2, block_n=2))
    assert (idx[:, 4:] == -1).all() and torch.isneginf(vals[:, 4:]).all()


def test_plain_topk_sign_vector_ties():
    """Entries +-1 at D=16: each cosine is a multiple of 1/8 (exact in
    every summation order), so almost every score ties and only the tie
    rule (lower corpus index first) decides the order."""
    rng = np.random.default_rng(9)
    c = rng.choice([-1.0, 1.0], size=(300, 16)).astype(np.float32)
    c[150:160] = c[10]                            # exact duplicate rows
    q = np.concatenate([rng.choice([-1.0, 1.0], size=(20, 16)), c[:4]])
    q = q.astype(np.float32)
    for k in (1, 8, 40, 300):
        got = ops.similarity_topk(torch.from_numpy(q), torch.from_numpy(c),
                                  k)
        # interpret mode unrolls k selection rounds: keep its k small
        for impl in ("reference", "interpret")[:1 + (k <= 40)]:
            _check_same(got, j_topk(jnp.asarray(q), jnp.asarray(c), k,
                                    impl=impl), exact_values=True)
    vals, idx = ops.similarity_topk(torch.from_numpy(c[10:11]),
                                    torch.from_numpy(c), 12)
    assert idx[0, :11].tolist() == [10] + list(range(150, 160))


@pytest.mark.parametrize("nlist,nprobe", [(8, 3), (16, 1), (1, 4)])
def test_ivf_index_matches_jax(nlist, nprobe):
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((6, 24)).astype(np.float32)
    vecs = (centers[rng.integers(0, 6, 400)]
            + 0.3 * rng.standard_normal((400, 24))).astype(np.float32)
    queries = rng.standard_normal((17, 24)).astype(np.float32)
    j = jsem.IvfFlatIndex(vecs, jsem.IvfConfig(nlist=nlist, nprobe=nprobe))
    t = tsem.IvfFlatIndex(vecs, tsem.IvfConfig(nlist=nlist, nprobe=nprobe),
                          device="cpu")
    assert t.nlist == j.nlist and t.num_vectors == j.num_vectors
    np.testing.assert_array_equal(t.centroids, j.centroids)
    np.testing.assert_array_equal(t.assign, j.assign)
    for a, b in zip(t.cells, j.cells):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.vectors.numpy(), j.vectors)
    for k in (1, 10, 450):                        # 450 > N pads with -1
        tv, ti = t.search_flat(queries, k)
        jv, ji = j.search_flat(queries, k)
        assert ti.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=VALUE_TOL)
        tv, ti = t.search(queries, k)
        jv, ji = j.search(queries, k)
        assert ti.dtype == ji.dtype == (np.int64 if nlist > 1 else np.int32)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=VALUE_TOL)
        assert t.measure_recall(queries, k) == j.measure_recall(queries, k)


@pytest.mark.parametrize("budget", [None, 4096])
def test_manager_matches_jax_over_simulated_clients(budget):
    """ensure_index / search (flat and IVF) / topk_candidates, coverage and
    the snapshot counters, over each package's simulated client; with a
    byte budget the store pages its vectors through the spill manager."""
    texts = [f"review {i}: the {['plot', 'cast', 'score'][i % 3]} was "
             f"{['great', 'dull', 'fine', 'odd'][i % 4]}" for i in range(96)]
    queries = [f"a note on the {w}" for w in ("plot", "cast", "music")]
    out = []
    for sem, client, kw in ((jsem, j_client(pipelined=True), {}),
                            (tsem, t_client(pipelined=True),
                             {"device": "cpu"})):
        mgr = sem.SemanticIndexManager(sem.SemIndexConfig(
            dim=32, embed_budget_bytes=budget, embed_page_rows=16), **kw)
        idx = mgr.ensure_index(client, "r.text", texts)
        assert mgr.ensure_index(client, "r.text", texts) is idx
        cov = mgr.coverage(client, texts[:50] + queries)
        qv = mgr.embed_texts(client, queries)
        res = [qv, idx.centroids, mgr.search("r.text", qv, 8),
               mgr.search("r.text", qv, 8, exact=False),
               mgr.topk_candidates(qv, mgr.embed_texts(client, texts), 20),
               mgr.ensure_index(client, "r.text", texts[:-1]).nlist]
        meters = client.snapshot()
        del meters["pipeline"]["queue_wait_s"]        # wall-clock time
        out.append((res, cov, mgr.snapshot(), meters))
    (jres, jcov, jsnap, jcl), (tres, tcov, tsnap, tcl) = out
    assert tcov == jcov and tsnap == jsnap and tcl == jcl
    assert tsnap["index_builds"] == 2 and tsnap["embed_llm_calls"] == 99
    np.testing.assert_array_equal(tres[0], jres[0])
    np.testing.assert_array_equal(tres[1], jres[1])
    for t, j in zip(tres[2:5], jres[2:5]):
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_allclose(t[0], j[0], rtol=0, atol=VALUE_TOL)
    assert tres[5] == jres[5] == 16


def test_store_saved_by_one_package_loads_in_the_other(tmp_path):
    rng = np.random.default_rng(12)
    texts = [f"t{i}" for i in range(20)]
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    jstore = jsem.EmbeddingStore()
    jstore.put("m", texts, vecs, dim=8)
    jstore.register_column("c", "m", texts, dim=8)
    jstore.save(str(tmp_path / "j"))
    tstore = tsem.EmbeddingStore(str(tmp_path / "j"))
    mat, keys = tstore.column_matrix("c")
    np.testing.assert_array_equal(mat, vecs)
    assert keys == jstore.column_matrix("c")[1]
    assert tsem.content_key("m", "t3", 8) == jsem.content_key("m", "t3", 8)
    tstore.put("m", ["extra"], vecs[:1], dim=8)
    tstore.save(str(tmp_path / "t"))
    back = jsem.EmbeddingStore(str(tmp_path / "t"))
    assert len(back) == 21
    np.testing.assert_array_equal(back.get("m", ["extra"], dim=8)[0],
                                  vecs[0])


def test_impl_and_device_contract():
    with pytest.raises(ValueError):
        tsem.IvfFlatIndex(np.eye(4, dtype=np.float32),
                          tsem.IvfConfig(impl="interpret"), device="cpu")
    with pytest.raises(ValueError):
        tsem.SemanticIndexManager(tsem.SemIndexConfig(impl="pallas"),
                                  device="cpu")
    with pytest.raises(ValueError):
        ops.similarity_topk(torch.ones(1, 2), torch.ones(3, 2), 1,
                            impl="interpret")
    vals, idx = ops.similarity_topk(torch.ones(2, 4), torch.ones(3, 4), 2,
                                    impl="reference")
    assert idx.tolist() == [[0, 1], [0, 1]]          # ties: lower index
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    for make in (lambda: tsem.SemanticIndexManager(),
                 lambda: tsem.IvfFlatIndex(np.eye(4, dtype=np.float32)),
                 lambda: make_engine_client()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
