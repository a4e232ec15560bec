#!/usr/bin/env python3
"""Train the slim RangeNet on synthetic-world scans with lis_slam_torch's
recipe (lis_slam_torch/train/recipe.py) and write the checkpoint.

The recipe of scripts/train_rangenet_synthetic.py, the script that made
the in-repo slim checkpoint, on PyTorch: 88 labelled HDL-64 images of four
procedural worlds, random 512-wide crops, Adam under a warm-up + cosine
schedule with a global-norm clip at 1.0, the held-out mIoU written into
the npz meta ("miou_synthetic", "steps"). The checkpoint loads in either
package (semantic/weights.load_checkpoint). It runs on the CUDA device,
or on the host with --cpu; without CUDA and without --cpu it raises.

    python scripts/train_rangenet_synthetic_torch.py [--steps 2500]
        [--batch 8] [--lr 2e-3] [--out PATH] [--cache PATH] [--cpu]

The defaults write under smoke_out/ of the checkout, never into a
package's weights/ directory; --cache holds this renderer's dataset (npz
of imgs, labs, masks), rendered and saved when the file is missing.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "smoke_out")


def load_or_render(path: str, device):
    """The recipe's dataset on `device`: from the npz at `path`, else
    rendered and saved there."""
    import numpy as np
    import torch

    from lis_slam_torch.train import recipe

    if os.path.exists(path):
        d = np.load(path)
        data = recipe.Dataset(*(torch.as_tensor(d[k], device=device)
                                for k in ("imgs", "labs", "masks")))
        print(f"loaded cached dataset {tuple(data.images.shape)}")
        return data
    t0 = time.perf_counter()
    data = recipe.render_dataset(device=device)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, imgs=data.images.cpu().numpy(),
             labs=data.labels.cpu().numpy(), masks=data.masks.cpu().numpy())
    print(f"rendered dataset {tuple(data.images.shape)} in "
          f"{time.perf_counter() - t0:.1f} s")
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=os.path.join(
        OUT_DIR, "rangenet_synthetic_slim_torch.npz"))
    ap.add_argument("--cache", default=os.path.join(
        OUT_DIR, "rangenet_synth_data_torch.npz"))
    ap.add_argument("--cpu", action="store_true",
                    help="train on the host instead of the CUDA device")
    args = ap.parse_args(argv)

    from lis_slam_torch.config import slim_semantic_config
    from lis_slam_torch.semantic import weights as W
    from lis_slam_torch.train import recipe
    from lis_slam_torch.utils import device as devices

    device = devices.resolve("cpu" if args.cpu else "cuda")
    data = load_or_render(args.cache, device)
    res = recipe.train(args.steps, batch=args.batch, lr=args.lr, data=data,
                       device=device,
                       log=lambda it, loss, s: print(
                           f"step {it:5d} loss {loss:.4f} ({s:.0f}s)",
                           flush=True))
    print(f"held-out mIoU {res.miou:.3f}  per-class {res.per_class}")
    W.save_checkpoint(args.out, res.variables, slim_semantic_config(),
                      meta={"miou_synthetic": res.miou,
                            "steps": args.steps})
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
