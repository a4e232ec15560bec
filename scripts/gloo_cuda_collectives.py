"""Which torch.distributed collectives gloo runs on CUDA tensors, with two
ranks sharing one card: each op in a spawn of its own (an op gloo does
not support on CUDA can abort its ranks); all_reduce, broadcast,
all_gather, all_gather_into_tensor, send/recv and batch_isend_irecv are
also checked for the values they deliver.
Prints one line per op and writes the table to OUT/gloo_cuda.json.

    python3 scripts/gloo_cuda_collectives.py [OUT]   # a GPU; OUT smoke_out
"""
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ["all_reduce", "all_reduce_f64", "broadcast", "all_gather",
       "all_gather_into_tensor", "reduce_scatter_tensor", "reduce_scatter",
       "all_to_all_single", "reduce", "send_recv", "batch_isend_irecv",
       "all_gather_object", "barrier", "mesh"]


def rank_fn(rank, world, backend, path, op):
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{path}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    x = torch.full((4, 3), float(rank + 1), device=dev)
    if op == "all_reduce":
        y = x.clone(); dist.all_reduce(y); assert float(y[0, 0]) == 3.0
    elif op == "all_reduce_f64":
        y = x.double(); dist.all_reduce(y); assert float(y[0, 0]) == 3.0
    elif op == "broadcast":
        y = x.clone(); dist.broadcast(y, 0); assert float(y[0, 0]) == 1.0
    elif op == "all_gather":
        ps = [torch.empty_like(x) for _ in range(world)]; dist.all_gather(ps, x)
        assert [float(p[0, 0]) for p in ps] == [1.0, 2.0]
    elif op == "all_gather_into_tensor":
        o = torch.empty((4 * world, 3), device=dev); dist.all_gather_into_tensor(o, x)
        assert float(o[4, 0]) == 2.0
    elif op == "reduce_scatter_tensor":
        o = torch.empty((4 // world, 3), device=dev); dist.reduce_scatter_tensor(o, x)
    elif op == "reduce_scatter":
        dist.reduce_scatter(torch.empty_like(x), [x.clone() for _ in range(world)])
    elif op == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif op == "reduce":
        dist.reduce(x.clone(), 0)
    elif op == "send_recv":
        if rank == 0: dist.send(x, 1)
        else:
            dist.recv(x, 0); assert float(x[0, 0]) == 1.0
    elif op == "batch_isend_irecv":
        other = 1 - rank; y = torch.empty_like(x)
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, other),
                                         dist.P2POp(dist.irecv, y, other)]):
            r.wait()
        assert float(y[0, 0]) == float(other + 1)
    elif op == "all_gather_object":
        o = [None] * world; dist.all_gather_object(o, rank)
    elif op == "barrier":
        dist.barrier()
    elif op == "mesh":
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        y = x.clone(); dist.all_reduce(y, group=m.get_group("model"))
        ps = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ps, x, group=m.get_group("model"))
    torch.cuda.synchronize()
    dist.destroy_process_group()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    out = sys.argv[1] if len(sys.argv) > 1 else "smoke_out"
    os.makedirs(out, exist_ok=True)
    res = {}
    for op in OPS:
        with tempfile.TemporaryDirectory() as d:
            try:
                mp.spawn(rank_fn, (2, "gloo", os.path.join(d, "rdv"), op),
                         nprocs=2)
                res[op] = "ok"
            except Exception as e:  # the op's failure is the finding
                res[op] = repr(e)[-300:]
        print(op, res[op], flush=True)
    with open(os.path.join(out, "gloo_cuda.json"), "w") as f:
        json.dump(res, f, indent=1)
