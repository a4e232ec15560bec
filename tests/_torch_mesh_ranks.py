"""Rank functions of the multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_train.py, tests/test_torch_conv_cpu.py), started
by lis_slam_torch.parallel.mesh.spawn. They live apart from the test
modules so that the rank processes import torch and the port only, never
JAX (but for dryrun_with_jaxlib, which loads jaxlib on purpose)."""

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lis_slam_torch import entry
from lis_slam_torch.models import rangenet as rn
from lis_slam_torch.parallel import batched
from lis_slam_torch.parallel import mesh as pmesh
from lis_slam_torch.semantic import weights as W
from lis_slam_torch.train import seg_train


def _everyone(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def layouts(rank, world_mesh, shapes, cfgs):
    """For each (model_parallel, spatial_parallel): the mesh's dim names,
    rank layout, every rank's coordinate and, for each RangeNet config of
    `cfgs`, the state_dict keys shard_params_tp splits (models built on the
    meta device). Also the error of a mesh larger than the world."""
    res = {}
    for mp, sp in shapes:
        m = pmesh.make_mesh(world_mesh.size(), mp, sp, device="cpu")
        split = {}
        for name, cfg in cfgs.items():
            with torch.device("meta"):
                state = rn.create_model(cfg).state_dict()
            split[name] = pmesh.shard_params_tp(state, m)[1]
        res[(mp, sp)] = (tuple(m.mesh_dim_names), m.mesh.tolist(),
                         _everyone(tuple(m.get_coordinate())), split)
    try:
        pmesh.make_mesh(world_mesh.size() + 1, device="cpu")
    except ValueError as e:
        res["too_large"] = str(e)
    return res


def replay(rank, mesh, sequences, cfg):
    """replay_batched over the mesh; also whether every rank returned the
    same poses."""
    poses = batched.replay_batched(sequences, cfg, mesh=mesh, device="cpu")
    same = all(torch.equal(torch.from_numpy(poses), torch.from_numpy(p))
               for p in _everyone(poses))
    return poses, same


def _model64(cfg, variables):
    model = rn.RangeNet(num_classes=cfg.num_classes,
                        in_features=cfg.model_input_c, dtype=torch.float64,
                        enc_blocks=cfg.enc_blocks, enc_widths=cfg.enc_widths,
                        dec_widths=cfg.dec_widths,
                        param_dtype=torch.float64).double()
    model.load_state_dict(W.to_torch_state(variables, cfg))
    return model.train()


def step64(mesh, cfg, variables, images, labels, mask):
    """One float64 sharded training step (mesh None: the world of one):
    loss, grad_norm and every gradient, whole."""
    model = _model64(cfg, variables)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step, shard_state, _ = seg_train.make_sharded_train_step(model, opt, mesh)
    shard_state(model, opt)
    img, pl = pmesh.shard_images(mesh), pmesh.shard_planes(mesh)
    out = step(img(torch.as_tensor(images)).double(),
               pl(torch.as_tensor(labels)), pl(torch.as_tensor(mask)))
    grads = {n: shard_state.placements[n].gather(p.grad)
             for n, p in model.named_parameters()}
    return float(out["loss"]), float(out["grad_norm"]), grads


def _halo_conv(mesh, kind, x, w, g):
    """One float64 convolution of the sharded forward on width blocks over
    'space': the gathered output, input gradient and the weight gradient
    summed over the ranks."""
    sh = rn._Sharding(nn.Module(), mesh, ())
    if kind == "deconv":
        conv = nn.ConvTranspose2d(w.shape[0], w.shape[1], (1, 4),
                                  stride=(1, 2), padding=(0, 1), bias=False,
                                  dtype=torch.float64)
    else:
        conv = nn.Conv2d(w.shape[1], w.shape[0], (3, 3), bias=False,
                         stride=(1, 2 if kind == "down" else 1),
                         dtype=torch.float64)
    with torch.no_grad():
        conv.weight.copy_(w)
    sh.names[id(conv)] = "conv"
    cols = pmesh.Placement(mesh, ((3, "space"),))
    xl = cols(x).clone().requires_grad_(True)
    y = rn._conv_sharded(conv, xl, sh)
    (y * cols(g)).sum().backward()
    return (cols.gather(y.detach()), cols.gather(xl.grad),
            pmesh.all_reduce(conv.weight.grad, sh.space))


def _batch_norm(mesh, x, weight, bias):
    """Train-mode BatchNorm of the sharded forward on (data, space) blocks
    of float32 x (B, C, H, W): the gathered output and the running
    statistics."""
    bn = rn._bn2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    sh = rn._Sharding(nn.Module(), mesh, ())
    blocks = pmesh.Placement(mesh, ((0, "data"), (3, "space")))
    y = rn._batch_norm_sharded(bn, blocks(x), sh, False)
    return blocks.gather(y), bn.running_mean.clone(), bn.running_var.clone()


def _state_round_trip(mesh, cfg, variables):
    """A JAX TrainState loaded whole (load_jax_train_state, moments set
    from the weights), cut into this rank's shard and gathered back:
    whether the weights and every Adam moment came back bit for bit, and
    whether the shard held fewer values than the whole."""
    model, opt = seg_train.create_train_state(cfg, None, device="cpu",
                                              variables=variables)
    _step, shard_state, _ = seg_train.make_sharded_train_step(model, opt,
                                                              mesh)
    def squared(tree):
        return {k: squared(v) if isinstance(v, dict) else v * v
                for k, v in tree.items()}

    sq = squared(variables["params"])
    seg_train.load_jax_train_state(model, opt, cfg, variables["params"],
                                   variables["batch_stats"],
                                   variables["params"], sq, 3)
    whole = {n: (p.detach().clone(), opt.state[p]["exp_avg"].clone(),
                 opt.state[p]["exp_avg_sq"].clone())
             for n, p in model.named_parameters()}
    shard_state(model, opt)
    smaller = sum(p.numel() for p in model.parameters()) < sum(
        w[0].numel() for w in whole.values())
    shard_state.gather(model, opt)
    same = all(torch.equal(p, whole[n][0])
               and torch.equal(opt.state[p]["exp_avg"], whole[n][1])
               and torch.equal(opt.state[p]["exp_avg_sq"], whole[n][2])
               for n, p in model.named_parameters())
    return same, smaller


def sharded_train_checks(rank, world_mesh, cfg, variables, images, labels,
                         mask, conv_cases, bn_case):
    """The 4-rank checks of tests/test_torch_sharded_train.py: the float32
    and float64 steps on (data 2, model 2) and (model 2, space 2), the
    halo convolutions over 4 'space' ranks, BatchNorm over (data 2,
    space 2), and every rank's state sharding round trip."""
    res = {}
    for mp, sp in ((2, 1), (2, 2)):
        res[("f32", mp, sp)] = seg_train.train_sharded(
            rank, world_mesh, cfg, variables, images, labels, mask,
            lr=3e-3, steps=1, model_parallel=mp, spatial_parallel=sp)
        mesh = pmesh.make_mesh(None, mp, sp, device="cpu")
        res[("f64", mp, sp)] = step64(mesh, cfg, variables, images, labels,
                                      mask)
    space4 = pmesh.make_mesh(None, 1, 4, device="cpu")
    res["conv"] = {kind: _halo_conv(space4, kind, *args)
                   for kind, args in conv_cases.items()}
    res["bn"] = _batch_norm(pmesh.make_mesh(None, 1, 2, device="cpu"),
                            *bn_case)
    res["round_trip"] = _everyone(_state_round_trip(
        pmesh.make_mesh(None, 2, 2, device="cpu"), cfg, variables))
    return res


def conv_reference(kind, x, w, g):
    """The unsharded convolution of _halo_conv with flax's "SAME" pads
    written out: output, input and weight gradients."""
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    if kind == "deconv":
        y = F.conv_transpose2d(x, w, None, (1, 2), (0, 1))
    elif kind == "down":  # width pads (0, 1) at stride 2
        y = F.conv2d(F.pad(x, (0, 1, 1, 1)), w, stride=(1, 2))
    else:
        y = F.conv2d(x, w, padding=1)
    (y * g).sum().backward()
    return y.detach(), x.grad, w.grad


def dryrun_with_jaxlib(rank, world_mesh, cfg):
    """entry.dryrun_multichip's rank with jaxlib loaded into the process
    first. Loading it moves what lies in the memory torch's CPU bf16
    convolution read where a stride-2 conv leaves one output column: the
    sharded step's loss came out NaN in every call before the port's bf16
    convolutions ran in float32 on the CPU. The import stays here, in
    the body: the rank processes of the other tests load no JAX."""
    import jax  # noqa: F401

    return entry._dryrun_rank(rank, world_mesh, cfg)
