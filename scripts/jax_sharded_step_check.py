"""The JAX package's sharded RangeNet training step against its unsharded
step, on each mesh of 8 (or 4) virtual CPU devices that a batch of 2
splits over: the slim widths of tests/test_torch_sharded_train.py,
64 x 128, float32, PRNGKey(0)'s weights, the same seeded batch.

Prints, per mesh, the loss, the gradient's global norm and the three
leaves whose gradient (Adam's first moment / 0.1) is furthest from the
unsharded step's, as a share of the leaf's largest entry.

    python scripts/jax_sharded_step_check.py      # ~1 min on a CPU
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lis_slam_tpu.config import slim_semantic_config  # noqa: E402
from lis_slam_tpu.parallel import mesh as jmesh  # noqa: E402
from lis_slam_tpu.train import seg_train  # noqa: E402


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v, np.float32)})
    return out


def main():
    cfg = dataclasses.replace(slim_semantic_config(), fp16=False,
                              model_input_w=128)
    model, tx, state = seg_train.create_train_state(
        jax.random.PRNGKey(0), cfg, lr=3e-3, input_w=128)
    r = np.random.default_rng(0)
    shape = (2, 64, 128)
    batch = (jnp.asarray(r.normal(size=shape + (5,)).astype(np.float32)),
             jnp.asarray(r.integers(0, 20, shape).astype(np.int32)),
             jnp.asarray(r.random(shape) > 0.2))
    s0, m0 = jax.jit(seg_train.make_train_step(model, tx))(state, *batch)
    g0 = flat(s0.opt_state[0].mu)
    print("unsharded", {k: float(v) for k, v in m0.items()})
    for mp, sp in ((2, 2), (4, 1), (1, 4), (2, 1), (1, 2)):
        mesh = jmesh.make_mesh(2 * mp * sp, model_parallel=mp,
                               spatial_parallel=sp)
        step, shard_state, _ = seg_train.make_sharded_train_step(model, tx,
                                                                 mesh)
        img, pl = jmesh.shard_images(mesh), jmesh.shard_planes(mesh)
        s, m = step(shard_state(state), jax.device_put(batch[0], img),
                    jax.device_put(batch[1], pl), jax.device_put(batch[2], pl))
        g = flat(s.opt_state[0].mu)
        worst = sorted(((float(np.abs(g[k] - g0[k]).max()
                               / np.abs(g0[k]).max()), k) for k in g0),
                       reverse=True)[:3]
        print(dict(mesh.shape), {k: float(v) for k, v in m.items()}, worst)


if __name__ == "__main__":
    main()
