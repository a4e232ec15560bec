"""The port's device mesh (lis_slam_torch/parallel/mesh.py) and its
lane-sharded odometry replay (parallel/batched.py make_sharded_step,
replay_batched(mesh=...)) on gloo ranks on the CPU, against the JAX
package's lis_slam_tpu/parallel.

- make_mesh's dim names, shape and rank layout for (4, 1, 1), (4, 2, 1)
  and (8, 2, 2) (devices, model, space) equal to the JAX mesh's on the
  virtual CPU devices (row-major, rank r at ((d mp) + m) sp + s), every
  rank's coordinate its place in the layout, and a mesh larger than the
  world refused;
- shard_params_tp splitting the same leaves as the JAX rule on the full
  darknet53 and the slim trees at 2 and 4 'model' ranks (the JAX side on
  jax.eval_shape leaves, the port's on meta tensors: nothing allocated);
- replay_batched over 2 ranks, 4 lanes of rendered HDL-64 scans (450 of
  1800 columns, tests/test_torch_batched.py's circuit): bit-equal per
  lane to the unsharded replay, and the same on both ranks. The JAX
  package's sharded replay_batched(mesh=make_mesh(2)) on the same scans
  is compared in a slow test (one ~2 min vmap compile): within 0.02 m,
  the bar of the two packages' free-running unsharded replays
  (tests/test_torch_batched.py).

The rank processes import tests/_torch_mesh_ranks.py, never JAX.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import _torch_mesh_ranks as ranks
from lis_slam_tpu.config import SemanticConfig as JSemanticConfig
from lis_slam_tpu.config import slim_semantic_config as jslim
from lis_slam_tpu.models import rangenet as jrn
from lis_slam_tpu.parallel import mesh as jmesh
from lis_slam_torch.config import SemanticConfig, SensorConfig, SlamConfig
from lis_slam_torch.io import synthetic
from lis_slam_torch.parallel import batched
from lis_slam_torch.parallel import mesh as pmesh

H = 450
N_SCANS = 3
STARTS = (0, 0, 1, 2)  # lanes 0 and 1 the same sequence
FREE_RUN_ATOL = 0.02  # m, tests/test_torch_batched.py


def _cfg():
    cfg = SlamConfig().replace(sensor=SensorConfig(horizon_scan=H,
                                                   max_raw_points=64 * H))
    return cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                   batched_kf_every=1))


def _sem_cfgs():
    return {"darknet53": JSemanticConfig(), "slim": jslim()}


@pytest.fixture(scope="module")
def runs():
    """The 4- and 8-rank layouts and the 2-rank replay in threads, the
    unsharded replay here meanwhile."""
    world = synthetic.make_world(seed=5)
    gt = synthetic.circular_trajectory(N_SCANS + 3, radius=60.0, speed=8.0)
    clouds = []
    for i in range(N_SCANS + 2):
        s = synthetic.render_scan(world, gt[i], None, horizon=H, seed=50 + i)
        clouds.append(s.points[s.valid])
    seqs = [clouds[s:s + N_SCANS] for s in STARTS]
    cfgs = {k: SemanticConfig(**dataclasses.asdict(v))
            for k, v in _sem_cfgs().items()}
    with ThreadPoolExecutor(3) as pool:
        l4 = pool.submit(pmesh.spawn, 4, ranks.layouts, ((1, 1), (2, 1)),
                         cfgs, device="cpu")
        l8 = pool.submit(pmesh.spawn, 8, ranks.layouts, ((2, 2), (4, 1)),
                         cfgs, device="cpu")
        rep = pool.submit(pmesh.spawn, 2, ranks.replay, seqs, _cfg(),
                          device="cpu")
        host = batched.replay_batched(seqs, _cfg(), device="cpu")
        return dict(seqs=seqs, host=host, replay=rep.result(),
                    layouts={4: l4.result(), 8: l8.result()})


@pytest.mark.parametrize("n,mp,sp", [(4, 1, 1), (4, 2, 1), (8, 2, 2)])
def test_make_mesh_layout_matches_jax(runs, n, mp, sp):
    names, layout, coords, _split = runs["layouts"][n][(mp, sp)]
    jm = jmesh.make_mesh(n, model_parallel=mp, spatial_parallel=sp)
    assert names == tuple(jm.axis_names)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(np.asarray(layout), ids)
    for rank, coord in enumerate(coords):
        assert np.asarray(layout)[coord] == rank
    assert "n_devices" in runs["layouts"][n]["too_large"]


def _jax_split(cfg, mesh):
    """The torch keys of the leaves JAX's shard_params_tp splits."""
    shapes = jax.eval_shape(jrn.create_model(cfg).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 5)))
    specs = jmesh.shard_params_tp(shapes["params"], mesh)
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    out = []
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        if any(p is not None for p in sh.spec):
            keys = [k.key for k in path]
            out.append(".".join(keys[:-1] + [leaf[keys[-1]]]))
    return sorted(out)


@pytest.mark.parametrize("name", ["darknet53", "slim"])
@pytest.mark.parametrize("n,mp", [(4, 2), (8, 4)])
def test_shard_params_tp_matches_jax(runs, name, n, mp):
    split = runs["layouts"][n][(mp, 1)][3][name]
    want = _jax_split(_sem_cfgs()[name], jmesh.make_mesh(
        n, model_parallel=mp))
    assert split == want
    assert len(split) > 10


def test_sharded_replay_bit_equal(runs):
    poses, same = runs["replay"]
    assert same
    assert poses.shape == (len(STARTS), N_SCANS, 6)
    assert np.array_equal(poses, runs["host"])
    assert np.array_equal(poses[0], poses[1])


@pytest.mark.slow
def test_sharded_replay_matches_jax(runs):
    from lis_slam_tpu.config import SensorConfig as JSensorConfig
    from lis_slam_tpu.config import SlamConfig as JSlamConfig
    from lis_slam_tpu.parallel import batched as jbatched
    from lis_slam_tpu.pipeline import driver as jdriver

    jcfg = JSlamConfig().replace(sensor=JSensorConfig(
        horizon_scan=H, max_raw_points=64 * H))
    jcfg = jcfg.replace(runtime=dataclasses.replace(jcfg.runtime,
                                                    batched_kf_every=1))
    seqs = [[jdriver.pad_scan(c, jcfg) for c in seq] for seq in runs["seqs"]]
    ref = jbatched.replay_batched(seqs, jcfg, mesh=jmesh.make_mesh(
        2, model_parallel=1))
    assert ref.shape == runs["replay"][0].shape
    gap = np.abs(runs["replay"][0][..., 3:] - ref[..., 3:]).max()
    print(f"port vs JAX sharded replay: max position gap {gap} m")
    assert gap < FREE_RUN_ATOL, gap
