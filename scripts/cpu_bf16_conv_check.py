"""torch's own CPU bf16 convolution against the port's (models/rangenet.py
`_conv`: float32, rounded once to bf16) at the encoder's strided conv as
the sharded forward calls it (3 x 3, stride (1, 2), 48 -> 64 channels, an
input 66 rows high and W columns wide, no width pads), W = 3, 4, 5, 8, 64.

Prints, per width: the output columns; in how many of 20 calls on an
all-zero input each returned a nonzero value (each call after one on
random inputs); and on random inputs the largest error of each against
the float32 convolution of the same bf16 values, relative to its largest
magnitude (NaN where the output held one).

    python scripts/cpu_bf16_conv_check.py      # seconds, torch only
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from lis_slam_torch.models import rangenet as rn  # noqa: E402

CALLS = 20


def _rel(y, ref):
    err = (y.double() - ref.double()).abs().max()
    return float(err / ref.double().abs().max())


def main():
    r = np.random.default_rng(0)
    w = torch.from_numpy(r.normal(size=(64, 48, 3, 3)) / np.sqrt(432)).to(
        torch.bfloat16)
    print(f"torch {torch.__version__}")
    for width in (3, 4, 5, 8, 64):
        x = torch.from_numpy(r.normal(size=(1, 48, 66, width))).to(
            torch.bfloat16)
        zero = torch.zeros_like(x)
        ref = F.conv2d(x.float(), w.float(), None, (1, 2))
        row = [f"W {width}: {ref.shape[3]} output columns"]
        for name, conv in (("torch bf16", lambda a: F.conv2d(a, w, None,
                                                             (1, 2))),
                           ("port", lambda a: rn._conv(a, w, None, (1, 2)))):
            bad = 0
            for _ in range(CALLS):
                y = conv(x)
                bad += bool(torch.count_nonzero(conv(zero)))
            row.append(f"{name}: nonzero on zeros {bad}/{CALLS}, "
                       f"error {_rel(y, ref):.3g}")
        print("; ".join(row), flush=True)


if __name__ == "__main__":
    main()
