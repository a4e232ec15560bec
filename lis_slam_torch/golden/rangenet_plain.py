"""RangeNet++ darknet53's forward pass in plain torch.nn.functional and
float32, from the flax-layout weight tree ({"params", "batch_stats"},
'/'-joined module paths, HWIO kernels): the reference the port's
`models/rangenet.py` is held to. It imports nothing of the port.

The network (rangenet_lib's darknet53 backbone-OS32): a 3x3 stem conv to
32 channels; 5 stages, each a 3x3 conv of stride (1, 2) and N residual
blocks (1x1 conv to half the width, 3x3 conv back, plus the input), N =
1, 2, 8, 8, 4 at widths 64 to 1024; every conv without bias, followed by
BatchNorm with the running statistics and leaky ReLU 0.1; the input of
each stage kept as a skip. A decoder of 5 blocks, each a transposed conv
(kernel (1, 4), stride (1, 2)) that doubles the width, BatchNorm, leaky
ReLU, a 3x3 conv block, plus the skip of its width; a 1x1 head with bias
to the class logits. The input is the normalized (range, x, y, z,
intensity) image, (B, H, W, 5), W a multiple of 32; the output (B, H, W,
classes).

Departures of the port's module from the released model, as the
repository's sources state them (this reference follows the port, so
that the two are held to the same arithmetic):
- the strided convs pad the width (0, 1), flax's "SAME" for kernel 3 and
  stride 2 on an even width, not (1, 1) (models/rangenet.py);
- the transposed conv's kernel is applied as flax's ConvTranspose stores
  it, unflipped; the ONNX importer carries a released ConvTranspose
  kernel over without the flip, so a released decoder would come out
  mirrored along the width (semantic/weights.py `map_ordered_weights`);
- BatchNorm's epsilon is flax's 1e-4 (models/rangenet.py `_bn2d`): the
  importer reads a BatchNormalization node's scale, bias, mean and
  variance and not its epsilon, and the released engine fuses BatchNorm
  into a scale where the port runs it (docs/PARITY.md row 11);
- a skip whose width differs from its decoder block's goes through a
  1x1 projection without bias (models/rangenet.py `UpBlock`), which the
  importer's layer sequence expects (`expected_layer_sequence`); at
  darknet53's published widths every skip matches and there is none;
- the head is the one conv with a bias (the importer tells it by that
  bias) and runs in float32, as every layer of the reference's engine
  does (fp16 disabled, netTensorRT.cpp:607), where the port runs its
  other convs in bf16 under `SemanticConfig.fp16`.

`forward` switches TF32 off for cuBLAS and cuDNN, so that a float32
forward on the card is float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-4
SLOPE = 0.1


def tensors(tree: dict, device) -> dict:
    """The flax-layout tree as float32 tensors on `device`, same nesting."""
    return {k: tensors(v, device) if isinstance(v, dict) else
            torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


def _same(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, kernel, stride=(1, 1), bias=None):
    """"SAME" convolution of NCHW `x` with an HWIO `kernel`."""
    kh, kw = kernel.shape[:2]
    (hl, hh), (wl, wh) = (_same(x.shape[2], kh, stride[0]),
                          _same(x.shape[3], kw, stride[1]))
    x = F.pad(x, (wl, wh, hl, hh))
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride)


def conv_transpose(x, kernel):
    """flax's ConvTranspose, kernel (1, 4), stride (1, 2), "SAME": the
    input dilated by 2 along the width and padded (2, 2) there, correlated
    with the kernel as stored. F.conv_transpose2d correlates with the
    flipped kernel, over a padding of kernel - 1 - 1 = 2."""
    w = kernel.permute(2, 3, 0, 1).flip(-1)  # (I, O, kH, kW)
    return F.conv_transpose2d(x, w, stride=(1, 2), padding=(0, 1))


def batch_norm(x, p, s):
    inv = torch.rsqrt(s["var"] + BN_EPS) * p["scale"]
    return ((x - s["mean"][:, None, None]) * inv[:, None, None]
            + p["bias"][:, None, None])


def cbl(x, p, s, stride=(1, 1)):
    """conv, BatchNorm, leaky ReLU."""
    y = conv(x, p["Conv_0"]["kernel"], stride)
    return F.leaky_relu(batch_norm(y, p["BatchNorm_0"], s["BatchNorm_0"]),
                        SLOPE)


def forward(w: dict, x: torch.Tensor, blocks=(1, 2, 8, 8, 4)) -> torch.Tensor:
    """Logits (B, H, W, classes) of the normalized image `x` (B, H, W, C),
    float32, with `w` the tree of `tensors`; `blocks`: residual blocks a
    stage (the widths come from the kernels)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, s = w["params"], w["batch_stats"]
    pe, se = p["Darknet53Encoder_0"], s["Darknet53Encoder_0"]
    y = cbl(x.float().permute(0, 3, 1, 2), pe["ConvBnLeaky_0"],
            se["ConvBnLeaky_0"])
    skips, rb = [], 0
    for i, n in enumerate(blocks):
        skips.append(y)
        name = f"ConvBnLeaky_{i + 1}"
        y = cbl(y, pe[name], se[name], (1, 2))
        for _ in range(n):
            pr, sr = pe[f"ResidualBlock_{rb}"], se[f"ResidualBlock_{rb}"]
            h = cbl(y, pr["ConvBnLeaky_0"], sr["ConvBnLeaky_0"])
            y = y + cbl(h, pr["ConvBnLeaky_1"], sr["ConvBnLeaky_1"])
            rb += 1
    for i, skip in enumerate(reversed(skips)):
        pu, su = p[f"UpBlock_{i}"], s[f"UpBlock_{i}"]
        y = conv_transpose(y, pu["ConvTranspose_0"]["kernel"])
        y = F.leaky_relu(batch_norm(y, pu["BatchNorm_0"], su["BatchNorm_0"]),
                         SLOPE)
        y = cbl(y, pu["ConvBnLeaky_0"], su["ConvBnLeaky_0"])
        if "Conv_0" in pu:  # the skip's 1x1 projection
            skip = conv(skip, pu["Conv_0"]["kernel"])
        y = y + skip
    head = p["Conv_0"]
    return conv(y, head["kernel"], bias=head["bias"]).permute(0, 2, 3, 1)
