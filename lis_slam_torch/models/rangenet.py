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

Training (train/seg_train.py) runs the module in train mode with
`param_dtype` float32: the parameters stay float32 and each convolution
casts its kernel to the compute dtype, as flax does. BatchNorm in train
mode is flax's: it normalizes with the batch mean and the biased batch
variance E[x^2] - E[x]^2 (clipped at 0) over (N, H, W), and moves the
running statistics by flax's momentum 0.99 (torch's 0.01) toward the
batch mean and that same biased variance. nn.BatchNorm2d's own update
takes the unbiased variance, so the update is done here by hand.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SemanticConfig
from ..parallel import mesh as pmesh

_STEM = 32  # stem conv width (the released darknet53's)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` with "SAME" padding, its kernel cast to x's dtype; asymmetric
    pads (the strided convs) go through F.pad, symmetric ones into the
    convolution."""
    (hl, hh), (wl, wh) = (_same_pads(x.shape[2 + i], conv.kernel_size[i],
                                     conv.stride[i]) for i in range(2))
    w = conv.weight.to(x.dtype)
    if hl == hh and wl == wh:
        return F.conv2d(x, w, conv.bias, conv.stride, (hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, conv.bias, conv.stride)


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm of float32 NCHW `x`: eval mode with the running
    statistics; train mode as flax's (see the module docstring)."""
    if not bn.training:
        return bn(x)
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None,
                                                                   None]


def _bn2d(features: int) -> nn.BatchNorm2d:
    # flax BatchNorm(momentum=0.99, epsilon=1e-4)
    return nn.BatchNorm2d(features, eps=1e-4, momentum=0.01)


class ConvBnLeaky(nn.Module):
    """Conv (no bias, compute dtype) -> BatchNorm -> leaky ReLU 0.1, the
    last two in float32. The kernel is held in `param_dtype` (default the
    compute dtype)."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3),
                 strides=(1, 1), dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride=strides,
                                bias=False, dtype=param_dtype or dtype)
        self.BatchNorm_0 = _bn2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_same(self.Conv_0, x.to(self.dtype))
        return F.leaky_relu(_batch_norm(self.BatchNorm_0, x.float()), 0.1)


class ResidualBlock(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.ConvBnLeaky_0 = ConvBnLeaky(features, features // 2, (1, 1),
                                         dtype=dtype, param_dtype=param_dtype)
        self.ConvBnLeaky_1 = ConvBnLeaky(features // 2, features, dtype=dtype,
                                         param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvBnLeaky_1(self.ConvBnLeaky_0(x))


class Darknet53Encoder(nn.Module):
    """OS-32 encoder, width-only strides. Returns (features, skips): the
    skips are taken before each downsample."""

    def __init__(self, in_features: int, blocks=(1, 2, 8, 8, 4),
                 widths=(64, 128, 256, 512, 1024),
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        pd = dict(dtype=dtype, param_dtype=param_dtype)
        # registered in graph order, under flax's names
        self.ConvBnLeaky_0 = ConvBnLeaky(in_features, _STEM, **pd)
        self.stages: list[tuple[str, list[str]]] = []
        prev, rb = _STEM, 0
        for i, (n_blocks, width) in enumerate(zip(blocks, widths)):
            down = f"ConvBnLeaky_{i + 1}"
            self.add_module(down, ConvBnLeaky(prev, width, strides=(1, 2),
                                              **pd))
            res = []
            for _ in range(n_blocks):
                res.append(f"ResidualBlock_{rb}")
                self.add_module(res[-1], ResidualBlock(width, **pd))
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
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        # flax "SAME" for kernel 4, stride 2: output width 2 W, which is
        # torch's padding 1 (the kernel flipped, see weights.to_torch_state)
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            in_features, features, (1, 4), stride=(1, 2), padding=(0, 1),
            bias=False, dtype=pdt)
        self.BatchNorm_0 = _bn2d(features)
        self.ConvBnLeaky_0 = ConvBnLeaky(features, features, dtype=dtype,
                                         param_dtype=param_dtype)
        if skip_features != features:
            self.Conv_0 = nn.Conv2d(skip_features, features, 1, bias=False,
                                    dtype=pdt)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        t = self.ConvTranspose_0
        x = F.conv_transpose2d(x.to(self.dtype), t.weight.to(self.dtype),
                               None, t.stride, t.padding)
        x = F.leaky_relu(_batch_norm(self.BatchNorm_0, x.float()), 0.1)
        x = self.ConvBnLeaky_0(x)
        if hasattr(self, "Conv_0"):
            skip = F.conv2d(skip.to(self.dtype),
                            self.Conv_0.weight.to(self.dtype))
        return x + skip


class RangeNet(nn.Module):
    """Full encoder-decoder; input (B, H, W, C) with W % 32 == 0, output
    (B, H, W, num_classes) float32 logits."""

    def __init__(self, num_classes: int = 20, in_features: int = 5,
                 dtype: torch.dtype = torch.bfloat16,
                 enc_blocks=(1, 2, 8, 8, 4),
                 enc_widths=(64, 128, 256, 512, 1024),
                 dec_widths=(512, 256, 128, 64, 32),
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.Darknet53Encoder_0 = Darknet53Encoder(
            in_features, tuple(enc_blocks), tuple(enc_widths), dtype,
            param_dtype)
        skip_ch = [_STEM] + list(enc_widths[:-1])
        prev = enc_widths[-1]
        for i, feats in enumerate(dec_widths):
            self.add_module(f"UpBlock_{i}", UpBlock(
                prev, skip_ch[len(skip_ch) - 1 - i], feats, dtype,
                param_dtype))
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


def create_model(cfg: SemanticConfig,
                 param_dtype: torch.dtype | None = None) -> RangeNet:
    """The architecture of `cfg` in eval mode (NCHW inside) on the default
    device, parameters in the compute dtype unless `param_dtype` (float32
    for training); load weights with
    `model.load_state_dict(weights.to_torch_state(variables, cfg))`."""
    return RangeNet(num_classes=cfg.num_classes,
                    in_features=cfg.model_input_c,
                    dtype=torch.bfloat16 if cfg.fp16 else torch.float32,
                    enc_blocks=cfg.enc_blocks, enc_widths=cfg.enc_widths,
                    dec_widths=cfg.dec_widths,
                    param_dtype=param_dtype).eval()


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


# ---------------------------------------------------------------------------
# The sharded forward: tensor parallelism over 'model', the image width over
# 'space', batch items over 'data' (parallel/mesh.py)
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over
    'model'. Put before a convolution whose output channels are split over
    'model': each rank's gradient is its channels' part."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return pmesh.all_reduce(g.contiguous().clone(), ctx.ax), None


class _GatherChannels(torch.autograd.Function):
    """The channels of every 'model' rank, in rank order. Backward: this
    rank's slice of the gradient; every consumer of the gathered tensor
    runs on every 'model' rank, or sums its partial input gradient itself
    (_CopyToModel), so the slice is the whole gradient."""

    @staticmethod
    def forward(ctx, y, ax):
        ctx.ax, ctx.c = ax, y.shape[1]
        return torch.cat(pmesh.all_gather(y, ax), dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.ax.index * ctx.c, ctx.c), None


class _Halo(torch.autograd.Function):
    """(B, C, H, W) local columns with `left` columns of the left
    neighbour's and `right` of the right neighbour's on either side over
    'space', zeros at the global image edges. Backward: the halo columns'
    gradients go back to the ranks that own them."""

    @staticmethod
    def forward(ctx, x, ax, left, right):
        ctx.ax, ctx.left, ctx.right = ax, left, right
        w = x.shape[3]
        edges = torch.cat([x[..., :right], x[..., w - left:]], dim=3)
        parts = pmesh.all_gather(edges, ax)
        zl = x.new_zeros(x.shape[:3] + (left,))
        zr = x.new_zeros(x.shape[:3] + (right,))
        lh = parts[ax.index - 1][..., right:] if ax.index > 0 else zl
        rh = parts[ax.index + 1][..., :right] if ax.index + 1 < ax.size \
            else zr
        return torch.cat([lh, x, rh], dim=3)

    @staticmethod
    def backward(ctx, g):
        ax, left, right = ctx.ax, ctx.left, ctx.right
        w = g.shape[3] - left - right
        gx = g[..., left:left + w].clone()
        parts = pmesh.all_gather(
            torch.cat([g[..., :left], g[..., left + w:]], dim=3), ax)
        if ax.index > 0 and right:  # the left neighbour's right halo
            gx[..., :right] += parts[ax.index - 1][..., left:]
        if ax.index + 1 < ax.size and left:  # the right one's left halo
            gx[..., w - left:] += parts[ax.index + 1][..., :left]
        return gx, None, None, None


class _AllReduce(torch.autograd.Function):
    """Sum over mesh dims; the backward sums the gradient over the same
    dims (every rank's loss term reads the sum)."""

    @staticmethod
    def forward(ctx, x, *axes):
        ctx.axes = axes
        return pmesh.all_reduce(x.clone(), *axes)

    @staticmethod
    def backward(ctx, g):
        return (pmesh.all_reduce(g.contiguous().clone(), *ctx.axes),
                *(None for _ in ctx.axes))


class _Sharding:
    """What the sharded forward needs: the mesh's axes and the names of
    the parameters split over 'model'."""

    def __init__(self, model: "RangeNet", mesh, sharded):
        self.data = pmesh.axis(mesh, "data")
        self.model = pmesh.axis(mesh, "model")
        self.space = pmesh.axis(mesh, "space")
        self.sharded = set(sharded)
        self.names = {id(m): n for n, m in model.named_modules()}

    def split(self, module: nn.Module) -> bool:
        return f"{self.names[id(module)]}.weight" in self.sharded


def _conv_sharded(conv, x: torch.Tensor, sh: _Sharding) -> torch.Tensor:
    """`conv` (its kernel cast to x's dtype) on this rank's block: x (B,
    C, H, W_local) replicated over 'model'; the output holds this rank's
    output channels where the kernel is split over 'model', and its block
    of the global output's columns. Over 'space' a Conv2d takes flax's
    "SAME" pads of the whole width as halo columns, so its local output
    is W_local / stride wide; the decoder's ConvTranspose2d (kernel 4,
    stride 2, padding 1) takes one column a side and crops its output to
    2 W_local."""
    if sh.split(conv):
        x = _CopyToModel.apply(x, sh.model)
    transposed = isinstance(conv, nn.ConvTranspose2d)
    w = conv.weight.to(x.dtype)
    if sh.space.size == 1:
        if transposed:
            return F.conv_transpose2d(x, w, None, conv.stride, conv.padding)
        return _conv_same(conv, x)
    k, s = conv.kernel_size[1], conv.stride[1]
    if transposed:
        if (k, s, conv.padding[1]) != (4, 2, 1):
            raise ValueError("forward_sharded: a transposed conv other than "
                             "kernel 4, stride 2, padding 1 over 'space'")
        return F.conv_transpose2d(_Halo.apply(x, sh.space, 1, 1), w, None,
                                  conv.stride, (conv.padding[0], 1 + s))
    left, _ = _same_pads(x.shape[3] * sh.space.size, k, s)
    if k > 1:
        x = _Halo.apply(x, sh.space, left, k - s - left)
    hl, hh = _same_pads(x.shape[2], conv.kernel_size[0], conv.stride[0])
    return F.conv2d(F.pad(x, (0, 0, hl, hh)), w, conv.bias, conv.stride)


def _batch_norm_sharded(bn: nn.BatchNorm2d, x: torch.Tensor,
                        sh: _Sharding, split: bool) -> torch.Tensor:
    """_batch_norm on this rank's block: in train mode the statistics of
    the global batch over 'data' and 'space', by flax's rule as the
    unsharded forward takes it (the mean and E[x^2] from one all-reduced
    pair of sums, the biased variance E[x^2] - E[x]^2 clipped at 0, as
    JAX's GSPMD step computes them), the running statistics (whole on
    every rank) moved identically everywhere; `split`: x holds this
    rank's 'model' slice of the channels."""
    c = x.shape[1]
    sl = slice(sh.model.index * c, (sh.model.index + 1) * c) if split \
        else slice(None)
    if not bn.training:
        mean, var = bn.running_mean[sl], bn.running_var[sl]
    else:
        count = x.numel() // c * sh.data.size * sh.space.size
        sums = _AllReduce.apply(torch.stack([x.sum(dim=(0, 2, 3)),
                                             (x * x).sum(dim=(0, 2, 3))]),
                                sh.data, sh.space) / count
        mean = sums[0]
        var = torch.clamp(sums[1] - mean * mean, min=0.0)
        with torch.no_grad():
            stats = torch.stack([mean, var])
            if split:
                stats = torch.cat(pmesh.all_gather(stats, sh.model), dim=1)
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(stats[0], alpha=m)
            bn.running_var.mul_(1.0 - m).add_(stats[1], alpha=m)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + \
        bn.bias[:, None, None]


def _gather(y: torch.Tensor, sh: _Sharding, split: bool) -> torch.Tensor:
    return _GatherChannels.apply(y, sh.model) if split and \
        sh.model.group is not None else y


def _conv_bn_leaky(conv: nn.Module, bn: nn.BatchNorm2d, dtype: torch.dtype,
                   x: torch.Tensor, sh: _Sharding) -> torch.Tensor:
    """Conv (in `dtype`) -> BatchNorm -> leaky ReLU on this rank's block,
    the output channels gathered over 'model'."""
    split = sh.split(conv)
    if split != sh.split(bn):
        raise ValueError(f"{sh.names[id(conv)]} and its BatchNorm are not "
                         "split alike over 'model'")
    y = _conv_sharded(conv, x.to(dtype), sh)
    # BatchNorm in float32 (float64 stays: a float64 model checks the
    # sharding to float64 rounding)
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    y = F.leaky_relu(_batch_norm_sharded(bn, y, sh, split), 0.1)
    return _gather(y, sh, split)


def forward_sharded(model: RangeNet, x: torch.Tensor, mesh,
                    sharded) -> torch.Tensor:
    """RangeNet.forward on this rank's block of the image, x (B_local, H,
    W_local, C), over a parallel/mesh.py mesh: the parameters named in
    `sharded` hold this rank's 'model' slice of their output channels
    (parallel/mesh.shard_params_tp); each such convolution, its
    BatchNorm and leaky ReLU run on the slice and the channels are
    gathered over 'model' before the next consumer; every convolution
    with a kernel wider than 1 exchanges halo columns with its 'space'
    neighbours; train-mode BatchNorm takes the global batch's statistics
    (one all-reduce of two sums over 'data' and 'space').
    Returns this rank's block of the logits (B_local, H, W_local,
    num_classes), equal to the unsharded forward's up to float
    rounding. The local width must be a multiple of 32 (five stride-2
    stages)."""
    if x.shape[2] % 32:
        raise ValueError(f"forward_sharded: local width {x.shape[2]} is not "
                         "a multiple of 32")
    sh = _Sharding(model, mesh, sharded)

    def cbl(m, y):
        return _conv_bn_leaky(m.Conv_0, m.BatchNorm_0, m.dtype, y, sh)

    y = x.to(model.dtype).permute(0, 3, 1, 2).contiguous()
    enc = model.Darknet53Encoder_0
    y = cbl(enc.ConvBnLeaky_0, y)
    skips = []
    for down, res in enc.stages:
        skips.append(y)
        y = cbl(enc.get_submodule(down), y)
        for name in res:
            blk = enc.get_submodule(name)
            y = y + cbl(blk.ConvBnLeaky_1, cbl(blk.ConvBnLeaky_0, y))
    for i, skip in enumerate(reversed(skips)):
        up = model.get_submodule(f"UpBlock_{i}")
        y = _conv_bn_leaky(up.ConvTranspose_0, up.BatchNorm_0, up.dtype, y,
                           sh)
        y = cbl(up.ConvBnLeaky_0, y)
        if hasattr(up, "Conv_0"):
            skip = _gather(_conv_sharded(up.Conv_0, skip.to(up.dtype), sh),
                           sh, sh.split(up.Conv_0))
        y = y + skip
    head = model.Conv_0
    y = _gather(_conv_sharded(head, y, sh), sh, sh.split(head))
    return y.permute(0, 2, 3, 1)
