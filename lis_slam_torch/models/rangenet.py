"""RangeNet++ (darknet53 backbone) semantic segmentation as torch modules
(port of lis_slam_tpu/models/rangenet.py; reference src/segnet/
`NetTensorRT::infer`, netTensorRT.cpp:309-440, which runs a darknet53 ONNX
engine on a 64 x 2048 x 5 spherical range image).

Architecture (rangenet_lib's darknet53 backbone-OS32, arch_cfg.yaml of the
released model): a 3x3 stem conv (32), 5 stages of [downsample conv + N
residual blocks], N = 1, 2, 8, 8, 4, downsampling only along the width
(stride (1, 2)); a decoder of 5 width-upsampling transposed convs with skip
additions; a 1x1 head to num_classes logits.

The arithmetic points are the flax module's: the input is cast to the
compute dtype (bf16 when cfg.fp16, else float32) first; convolutions run
in the compute dtype; BatchNorm (eval, eps 1e-4), leaky ReLU 0.1 and the
residual and skip additions in float32; the 1x1 skip projection has no
bias and runs in the compute dtype; the class head runs in float32 with
its bias. Flax's "SAME" padding of the stride-(1, 2) convs is (0, 1) on
the width, not (1, 1), and its ConvTranspose does not flip its kernel
(weights.to_torch_state flips it for F.conv_transpose2d).

The interface is NHWC, as the JAX package's: (B, H, W, C) in, (B, H, W,
num_classes) out; inside it runs NCHW, the faster layout on an H100
(darknet53 bf16 at 64 x 2048: 4.94 against 7.68 ms per inference
channels-last, where cuDNN's BatchNorm took 4.57 ms). The submodules carry
flax's scope names (`Darknet53Encoder_0`, `UpBlock_2`, `Conv_0`, ...), so
a flax parameter path is a state_dict key; `expected_layer_sequence`
lists them in graph order.

The convolutions are cuDNN calls (F.conv2d / F.conv_transpose2d): the JAX
package leaves them to XLA, with no Pallas kernel on this path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SemanticConfig

_STEM = 32  # stem conv width (the released darknet53's)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` with "SAME" padding; asymmetric pads (the strided convs) go
    through F.pad, symmetric ones into the convolution."""
    (hl, hh), (wl, wh) = (_same_pads(x.shape[2 + i], conv.kernel_size[i],
                                     conv.stride[i]) for i in range(2))
    if hl == hh and wl == wh:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, (hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), conv.weight, conv.bias,
                    conv.stride)


class ConvBnLeaky(nn.Module):
    """Conv (no bias, compute dtype) -> BatchNorm -> leaky ReLU 0.1, the
    last two in float32."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3),
                 strides=(1, 1), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride=strides,
                                bias=False, dtype=dtype)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_same(self.Conv_0, x.to(self.dtype))
        return F.leaky_relu(self.BatchNorm_0(x.float()), 0.1)


class ResidualBlock(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.ConvBnLeaky_0 = ConvBnLeaky(features, features // 2, (1, 1),
                                         dtype=dtype)
        self.ConvBnLeaky_1 = ConvBnLeaky(features // 2, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvBnLeaky_1(self.ConvBnLeaky_0(x))


class Darknet53Encoder(nn.Module):
    """OS-32 encoder, width-only strides. Returns (features, skips): the
    skips are taken before each downsample."""

    def __init__(self, in_features: int, blocks=(1, 2, 8, 8, 4),
                 widths=(64, 128, 256, 512, 1024),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        # registered in graph order, under flax's names
        self.ConvBnLeaky_0 = ConvBnLeaky(in_features, _STEM, dtype=dtype)
        self.stages: list[tuple[str, list[str]]] = []
        prev, rb = _STEM, 0
        for i, (n_blocks, width) in enumerate(zip(blocks, widths)):
            down = f"ConvBnLeaky_{i + 1}"
            self.add_module(down, ConvBnLeaky(prev, width, strides=(1, 2),
                                              dtype=dtype))
            res = []
            for _ in range(n_blocks):
                res.append(f"ResidualBlock_{rb}")
                self.add_module(res[-1], ResidualBlock(width, dtype=dtype))
                rb += 1
            self.stages.append((down, res))
            prev = width

    def forward(self, x: torch.Tensor):
        x = self.ConvBnLeaky_0(x)
        skips = []
        for down, res in self.stages:
            skips.append(x)
            x = self.get_submodule(down)(x)
            for name in res:
                x = self.get_submodule(name)(x)
        return x, skips


class UpBlock(nn.Module):
    """Width-x2 transposed conv (kernel (1, 4), "SAME") -> BatchNorm ->
    leaky ReLU -> ConvBnLeaky, plus the skip (through a 1x1 projection
    when its width differs)."""

    def __init__(self, in_features: int, skip_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        # flax "SAME" for kernel 4, stride 2: output width 2 W, which is
        # torch's padding 1 (the kernel flipped, see weights.to_torch_state)
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            in_features, features, (1, 4), stride=(1, 2), padding=(0, 1),
            bias=False, dtype=dtype)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-4)
        self.ConvBnLeaky_0 = ConvBnLeaky(features, features, dtype=dtype)
        if skip_features != features:
            self.Conv_0 = nn.Conv2d(skip_features, features, 1, bias=False,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(x.to(self.dtype))
        x = F.leaky_relu(self.BatchNorm_0(x.float()), 0.1)
        x = self.ConvBnLeaky_0(x)
        if hasattr(self, "Conv_0"):
            skip = self.Conv_0(skip.to(self.dtype))
        return x + skip


class RangeNet(nn.Module):
    """Full encoder-decoder; input (B, H, W, C) with W % 32 == 0, output
    (B, H, W, num_classes) float32 logits."""

    def __init__(self, num_classes: int = 20, in_features: int = 5,
                 dtype: torch.dtype = torch.bfloat16,
                 enc_blocks=(1, 2, 8, 8, 4),
                 enc_widths=(64, 128, 256, 512, 1024),
                 dec_widths=(512, 256, 128, 64, 32)):
        super().__init__()
        self.dtype = dtype
        self.Darknet53Encoder_0 = Darknet53Encoder(
            in_features, tuple(enc_blocks), tuple(enc_widths), dtype)
        skip_ch = [_STEM] + list(enc_widths[:-1])
        prev = enc_widths[-1]
        for i, feats in enumerate(dec_widths):
            self.add_module(f"UpBlock_{i}", UpBlock(
                prev, skip_ch[len(skip_ch) - 1 - i], feats, dtype))
            prev = feats
        self.Conv_0 = nn.Conv2d(prev, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        y, skips = self.Darknet53Encoder_0(x)
        for i, skip in enumerate(reversed(skips)):
            y = self.get_submodule(f"UpBlock_{i}")(y, skip)
        return self.Conv_0(y).permute(0, 2, 3, 1)


def normalize_input(img: torch.Tensor, cfg: SemanticConfig) -> torch.Tensor:
    """Per-channel (x - mean) / std (netTensorRT.cpp:339-354)."""
    means = torch.as_tensor(cfg.img_means, dtype=torch.float32,
                            device=img.device)
    stds = torch.as_tensor(cfg.img_stds, dtype=torch.float32,
                           device=img.device)
    return (img - means) / stds


def build_input_image(rng_img, xyz_img, intensity_img, mask,
                      cfg: SemanticConfig) -> torch.Tensor:
    """(range, x, y, z, intensity) channels from the projected scan
    (doProjection's layout, netTensorRT.cpp:143-300), normalized, zero
    where the pixel is empty."""
    img = torch.cat([rng_img[..., None], xyz_img, intensity_img[..., None]],
                    dim=-1)
    img = normalize_input(img, cfg)
    return torch.where(mask[..., None], img, torch.zeros_like(img))


def expected_layer_sequence(cfg: SemanticConfig):
    """Graph-topological-order list of (param_path, kind) for the RangeNet
    architecture `cfg`, where kind is 'conv' (HWIO kernel, no bias),
    'deconv' (ConvTranspose), 'bn' (scale/bias/mean/var), or 'convb' (the
    class head, with bias). This is the layer-order contract an ONNX
    initializer stream is zipped against (the released darknet53.onnx
    serializes conv + BN initializers in the same topological order,
    netTensorRT.cpp:491-676 consumes them likewise)."""
    seq = []
    enc = "Darknet53Encoder_0"

    def cbl(prefix):
        seq.append((f"{prefix}/Conv_0", "conv"))
        seq.append((f"{prefix}/BatchNorm_0", "bn"))

    cbl(f"{enc}/ConvBnLeaky_0")  # stem
    rb = 0
    for i, nb in enumerate(cfg.enc_blocks):
        cbl(f"{enc}/ConvBnLeaky_{i + 1}")  # stride-2 downsample
        for _ in range(nb):
            cbl(f"{enc}/ResidualBlock_{rb}/ConvBnLeaky_0")
            cbl(f"{enc}/ResidualBlock_{rb}/ConvBnLeaky_1")
            rb += 1
    # decoder: skips are captured BEFORE each downsample, so their channel
    # counts are [stem, widths[0..-2]] and are consumed in reverse
    skip_ch = [_STEM] + list(cfg.enc_widths[:-1])
    for i, feats in enumerate(cfg.dec_widths):
        up = f"UpBlock_{i}"
        seq.append((f"{up}/ConvTranspose_0", "deconv"))
        seq.append((f"{up}/BatchNorm_0", "bn"))
        cbl(f"{up}/ConvBnLeaky_0")
        if skip_ch[len(skip_ch) - 1 - i] != feats:
            seq.append((f"{up}/Conv_0", "conv"))  # 1x1 skip projection
    seq.append(("Conv_0", "convb"))  # class head (bias, float32)
    return seq


def create_model(cfg: SemanticConfig) -> RangeNet:
    """The architecture of `cfg` in eval mode (NCHW inside) on the default
    device; load weights with
    `model.load_state_dict(weights.to_torch_state(variables, cfg))`."""
    return RangeNet(num_classes=cfg.num_classes,
                    in_features=cfg.model_input_c,
                    dtype=torch.bfloat16 if cfg.fp16 else torch.float32,
                    enc_blocks=cfg.enc_blocks, enc_widths=cfg.enc_widths,
                    dec_widths=cfg.dec_widths).eval()


def init_params(cfg: SemanticConfig, generator: torch.Generator) -> dict:
    """A flax-layout tree ({'params', 'batch_stats'}, numpy float32) drawn
    with flax's initializers from `generator` (a CPU torch.Generator):
    kernels lecun-normal (truncated to 2 sigma, fan-in kH kW I), the head's
    bias 0, BatchNorm scale 1, bias 0, mean 0, var 1. The draw is not
    JAX's; the parameter shapes do not depend on the input width."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in create_model(cfg).state_dict().items()}
    params, stats = {}, {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path.split("/"):
            node = node.setdefault(p, {})
        node[leaf] = value

    def lecun(shape_hwio):
        fan_in = math.prod(shape_hwio[:-1])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        t = torch.empty(shape_hwio)
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        return t.numpy()

    for path, kind in expected_layer_sequence(cfg):
        w = shapes[path.replace("/", ".") + ".weight"]
        if kind in ("conv", "convb"):
            o, i, kh, kw = w
            put(params, path, "kernel", lecun((kh, kw, i, o)))
            if kind == "convb":
                put(params, path, "bias", np.zeros(o, np.float32))
        elif kind == "deconv":
            i, o, kh, kw = w
            put(params, path, "kernel", lecun((kh, kw, i, o)))
        else:
            put(params, path, "scale", np.ones(w, np.float32))
            put(params, path, "bias", np.zeros(w, np.float32))
            put(stats, path, "mean", np.zeros(w, np.float32))
            put(stats, path, "var", np.ones(w, np.float32))
    return {"params": params, "batch_stats": stats}


def forward_flops(model: RangeNet, x: torch.Tensor) -> int:
    """FLOPs of one forward pass on `x` as torch's flop counter counts
    them from each convolution's shapes (2 per multiply-add, transposed
    convs over their input); BatchNorm, activations and adds are not
    counted. Runs `model` once: build both on the meta device to count
    without computing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        model(x)
    return int(counter.get_total_flops())
