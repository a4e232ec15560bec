#!/usr/bin/env python3
"""Where the time of the synthetic RangeNet recipe's training step goes,
on one NVIDIA GPU (lis_slam_torch/train/recipe.py, seg_train.
recipe_train_step: the slim net, batch 8 x 64 x 512 crops, bf16).

Prints the card's name and power limit, then one JSON line: the step's
device time (torch.profiler's CUDA activities summed, over --profile
steps), its CUDA activities a step and the kernels that take the most
device time; the step's ms by CUDA events over --steps back-to-back steps
on a fixed batch of crops; and the ms a step of recipe.train's own loop
(random crops, host clock, synced) over --loop steps. The profiler runs
last, once: a long trace can leave later profiler windows in the same
process without device records.

    python3 scripts/profile_recipe_step.py [--steps 40] [--loop 200]
        [--profile 3]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--loop", type=int, default=200)
    ap.add_argument("--profile", type=int, default=3)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lis_slam_torch.config import slim_semantic_config
    from lis_slam_torch.train import recipe, seg_train

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    data = recipe.render_dataset(device=dev)
    loop = recipe.train(args.loop, data=data, device=dev)
    model, opt = seg_train.create_train_state(
        slim_semantic_config(), torch.Generator().manual_seed(0), device=dev)
    step = seg_train.recipe_train_step(model, opt, 2500, 2e-3)
    w = recipe.CROP_W
    batch = (data.images[:8, :, :w].float(), data.labels[:8, :, :w].int(),
             data.masks[:8, :, :w])
    for _ in range(5):
        step(*batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step(*batch)
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.profile):
            step(*batch)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    n_act = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_act += 1
            name = e.name.split("(")[0][-60:]
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / args.profile
    device_ms = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "step_device_ms": device_ms,
        "cuda_activities_a_step": n_act / args.profile,
        "top_kernels_ms": top,
        "step_call_ms": call_ms,
        "loop_step_ms": 1e3 * loop.seconds / args.loop,
        "busy_share_of_call": device_ms / call_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
