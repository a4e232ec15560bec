"""RangeNet++ darknet53's forward pass in plain torch.nn.functional and
float32 (the benchmark's copy of lis_slam_torch/golden/rangenet_plain.py,
which it does not import), and the operations and bytes a forward needs.

The network (rangenet_lib's darknet53 backbone-OS32): a 3x3 stem conv to
32 channels; 5 stages, each a 3x3 conv of stride (1, 2) and N residual
blocks (1x1 conv to half the width, 3x3 conv back, plus the input), N =
1, 2, 8, 8, 4 at widths 64 to 1024; every conv without bias, followed by
BatchNorm with the running statistics and leaky ReLU 0.1; the input of
each stage kept as a skip. A decoder of 5 blocks, each a transposed conv
(kernel (1, 4), stride (1, 2)) that doubles the width, BatchNorm, leaky
ReLU, a 3x3 conv block, plus the skip of its width; a 1x1 head with bias
to the class logits. Weights come as the flax-layout tree the program
takes ({"params", "batch_stats"}, HWIO kernels); the input is the
program's normalized (range, x, y, z, intensity) image.

Departures of the program's module from the released model, as the
repository's sources state them (this reference follows the program):
the strided convs pad the width (0, 1), flax's "SAME", not (1, 1); the
transposed conv's kernel is applied unflipped, as flax stores it (a
released ONNX decoder, imported unflipped, would come out mirrored);
BatchNorm's epsilon is flax's 1e-4 (the importer does not read an ONNX
node's); a skip whose width differs from its decoder block's goes
through a 1x1 projection without bias (none at darknet53's widths); the
head is the one conv with a bias and runs in float32, as every layer of
the reference's engine does (fp16 disabled, netTensorRT.cpp:607).

`forward` switches TF32 off for cuBLAS and cuDNN. Its `rounding`, where
given, is applied to each convolution's input and kernel (the check's
control rounds them to float8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

STEM = 32
BN_EPS = 1e-4
SLOPE = 0.1
# one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor-core FLOP/s, HBM
# bytes/s
PEAK_BF16_FLOPS = 989.4e12
PEAK_BYTES = 3.35e12


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


def _identity(t):
    return t


class _Net:
    def __init__(self, w: dict, rounding=None):
        self.p, self.s = w["params"], w["batch_stats"]
        self.r = rounding or _identity

    def conv(self, x, kernel, stride=(1, 1), bias=None):
        """"SAME" convolution of NCHW `x` with an HWIO `kernel`."""
        kh, kw = kernel.shape[:2]
        (hl, hh), (wl, wh) = (_same(x.shape[2], kh, stride[0]),
                              _same(x.shape[3], kw, stride[1]))
        x = F.pad(self.r(x), (wl, wh, hl, hh))
        return F.conv2d(x, self.r(kernel).permute(3, 2, 0, 1), bias, stride)

    def conv_transpose(self, x, kernel):
        """flax's ConvTranspose, kernel (1, 4), stride (1, 2), "SAME": the
        input dilated by 2 along the width, padded (2, 2) there, and
        correlated with the kernel as stored; F.conv_transpose2d
        correlates with the flipped kernel over a padding of 4 - 1 - 1."""
        w = self.r(kernel).permute(2, 3, 0, 1).flip(-1)
        return F.conv_transpose2d(self.r(x), w, stride=(1, 2),
                                  padding=(0, 1))

    @staticmethod
    def bn(x, p, s):
        inv = torch.rsqrt(s["var"] + BN_EPS) * p["scale"]
        return ((x - s["mean"][:, None, None]) * inv[:, None, None]
                + p["bias"][:, None, None])

    def cbl(self, x, p, s, stride=(1, 1)):
        y = self.conv(x, p["Conv_0"]["kernel"], stride)
        return F.leaky_relu(self.bn(y, p["BatchNorm_0"], s["BatchNorm_0"]),
                            SLOPE)

    def __call__(self, x, blocks):
        p, s = self.p, self.s
        pe, se = p["Darknet53Encoder_0"], s["Darknet53Encoder_0"]
        y = self.cbl(x.float().permute(0, 3, 1, 2), pe["ConvBnLeaky_0"],
                     se["ConvBnLeaky_0"])
        skips, rb = [], 0
        for i, n in enumerate(blocks):
            skips.append(y)
            name = f"ConvBnLeaky_{i + 1}"
            y = self.cbl(y, pe[name], se[name], (1, 2))
            for _ in range(n):
                pr, sr = pe[f"ResidualBlock_{rb}"], se[f"ResidualBlock_{rb}"]
                h = self.cbl(y, pr["ConvBnLeaky_0"], sr["ConvBnLeaky_0"])
                y = y + self.cbl(h, pr["ConvBnLeaky_1"], sr["ConvBnLeaky_1"])
                rb += 1
        for i, skip in enumerate(reversed(skips)):
            pu, su = p[f"UpBlock_{i}"], s[f"UpBlock_{i}"]
            y = self.conv_transpose(y, pu["ConvTranspose_0"]["kernel"])
            y = F.leaky_relu(self.bn(y, pu["BatchNorm_0"], su["BatchNorm_0"]),
                             SLOPE)
            y = self.cbl(y, pu["ConvBnLeaky_0"], su["ConvBnLeaky_0"])
            if "Conv_0" in pu:  # the skip's 1x1 projection
                skip = self.conv(skip, pu["Conv_0"]["kernel"])
            y = y + skip
        head = p["Conv_0"]
        return self.conv(y, head["kernel"], bias=head["bias"]).permute(
            0, 2, 3, 1)


def forward(w: dict, x: torch.Tensor, blocks=(1, 2, 8, 8, 4),
            rounding=None) -> torch.Tensor:
    """Logits (B, H, W, classes) of the normalized image `x` (B, H, W, C),
    float32, with `w` the tree of `tensors`; `blocks`: residual blocks a
    stage (the widths come from the kernels)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        return _Net(w, rounding)(x, tuple(blocks))


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8_e4m3fn under one scale for the whole tensor
    (its largest magnitude onto e4m3's largest, 448), back in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _convs(arch: dict, h: int, w: int):
    """Each convolution of a forward at (h, w): (kind, width it sweeps,
    kernel area, in channels, out channels, followed by BatchNorm). A
    transposed conv sweeps its input's width, as torch's flop counter
    counts it."""
    blocks, widths = arch["blocks"], arch["widths"]
    out = [("conv", w, 9, arch["in_channels"], STEM, True)]
    skips, prev, cw = [], STEM, w
    for n, width in zip(blocks, widths):
        skips.append(prev)
        cw = -(-cw // 2)
        out.append(("conv", cw, 9, prev, width, True))
        out += [("conv", cw, 1, width, width // 2, True),
                ("conv", cw, 9, width // 2, width, True)] * n
        prev = width
    for feats, skip_c in zip(arch["dec_widths"], reversed(skips)):
        out.append(("deconv", cw, 4, prev, feats, True))
        cw *= 2
        out.append(("conv", cw, 9, feats, feats, True))
        if skip_c != feats:  # the skip's 1x1 projection
            out.append(("conv", cw, 1, skip_c, feats, False))
        prev = feats
    out.append(("head", cw, 1, prev, arch["classes"], False))
    return out


def flops(arch: dict, h: int, w: int) -> int:
    """Operations of one forward at (h, w): 2 per multiply-add of every
    convolution, as torch's flop counter counts them (BatchNorm, the
    activations, the adds and the head's bias left out). `arch`: blocks,
    widths, dec_widths, classes, in_channels."""
    return sum(2 * h * sweep * area * ci * co
               for _k, sweep, area, ci, co, _bn in _convs(arch, h, w))


def bytes_moved(arch: dict, h: int, w: int) -> int:
    """Bytes one forward must move: every weight once (the convolutions'
    kernels in bf16, the head's kernel and bias in float32, BatchNorm's
    four float32 vectors a layer), the float32 input image once and the
    float32 logits once."""
    total = 4 * h * w * (arch["in_channels"] + arch["classes"])
    for kind, _sweep, area, ci, co, bn in _convs(arch, h, w):
        total += 4 * (area * ci * co + co) if kind == "head" else \
            2 * area * ci * co
        total += 16 * co if bn else 0
    return total


def least_seconds(arch: dict, h: int, w: int) -> float:
    """The least time of one forward on one H100 at the bf16 peak:
    max(flops / 989.4 TFLOP/s, bytes / 3.35 TB/s)."""
    return max(flops(arch, h, w) / PEAK_BF16_FLOPS,
               bytes_moved(arch, h, w) / PEAK_BYTES)
