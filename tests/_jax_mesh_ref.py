"""The JAX package's two-device references for ``tests/test_torch_mesh.py``:
run in a process of its own, with ``XLA_FLAGS`` asking for two host
devices before JAX is first imported (the pytest process has one).

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \
        python tests/_jax_mesh_ref.py JOB.pkl OUT.pkl
"""
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _mesh(shape):
    """A mesh of Auto axes: the package's sharding constraints name its
    axes, which JAX allows only on Auto axes (``jax.make_mesh`` defaults
    to Explicit ones)."""
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh(shape, ("data", "model"), axis_types=auto)


def main(argv):
    with open(argv[1], "rb") as f:
        job = pickle.load(f)
    assert len(jax.devices()) == 2, jax.devices()
    import dataclasses
    from repro.configs import base as cfgs
    from repro.models import attention as attn
    from repro.models import model_zoo, shardctx
    res = {}
    if "decode_unit" in job:
        d = {k: jnp.asarray(v) for k, v in job["decode_unit"].items()}
        mesh = _mesh((1, 2))
        shardctx.enable(mesh)
        try:
            with mesh:
                out, ck, cv = attn.sharded_cache_decode(
                    d["q"], d["ck"], d["cv"], d["kn"], d["vn"], d["lengths"])
        finally:
            shardctx.disable()
        res["decode_unit"] = {"out": np.asarray(out), "ck": np.asarray(ck),
                              "cv": np.asarray(cv)}
    if "moe" in job:
        res["moe"] = {}
        for case in job["moe"]:
            cfg = dataclasses.replace(cfgs.get_smoke_config(case["arch"]),
                                      dtype="float32")
            model = model_zoo.build(cfg)
            params = jax.tree.map(jnp.asarray, case["params"])
            batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
            for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1))):
                mesh = _mesh(shape)
                shardctx.enable(mesh)
                try:
                    with mesh:
                        def fwd(p, b):
                            o = model.apply(p, b, mode="train")
                            return model.logits_of(p, o["hidden"]), o["aux"]
                        logits, aux = jax.jit(fwd)(params, batch)
                finally:
                    shardctx.disable()
                res["moe"][(case["arch"], name)] = {
                    "logits": np.asarray(logits, np.float32),
                    "aux": np.asarray(aux, np.float32)}
    with open(argv[2], "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
