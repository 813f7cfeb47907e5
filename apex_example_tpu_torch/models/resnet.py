"""ResNet-18/34/50/101/152: port of apex_example_tpu/models/resnet.py
(``BasicBlock`` :41, ``Bottleneck`` :66, ``ResNet`` :134, the builders
:236-260).

The torchvision architecture the reference imports: a 7x7/2 stem and a
3x3/2 max pool (or a CIFAR-style 3x3 stem, ``small_stem``), stages of
BasicBlocks [2, 2, 2, 2] / [3, 4, 6, 3] or Bottlenecks [3, 4, 6, 3] /
[3, 4, 23, 3] / [3, 8, 36, 3] with stride-2 downsampling, global average
pooling and a dense classifier.  Logits come out fp32.

Layout.  The public ``forward`` takes NHWC images, as the JAX model does,
and the activations stay NHWC between layers, so BatchNorm sees a (rows, C)
view with C contiguous.  A convolution permutes its input to NCHW, which
for a contiguous NHWC tensor is a view in ``channels_last`` memory, the
layout cuDNN wants, and permutes the output back, again a view.

Padding.  Flax's ``padding="SAME"`` is not torchvision's symmetric padding:
SAME pads ``(out - 1) * stride + k - in`` in all, the extra one at the end,
so the 7x7/2 stem on 224 px pads (2, 3) and each 3x3/2 conv on an even size
(0, 1), and the max pool pads (0, 1) with -inf (:201).
``nn.Conv2d(padding=3)`` would give a result of the same shape shifted by
one pixel.  So each layer computes SAME's pads from its input's size and
pads asymmetrically with ``F.pad`` where they differ.

Precision (amp, amp/autocast.py ``module_dtypes``).  Convolutions and the
classifier compute in ``dtype`` and cast their weights to it at call time,
so fp32 parameters stay the masters under O2, as flax's ``dtype`` /
``param_dtype`` do; under O3 ``param_dtype`` is half and the conv and fc
weights are stored half, while BatchNorm's parameters stay fp32 (:183).
BatchNorm's I/O is ``bn_io_dtype`` (None: ``dtype``) and its normalization
``bn_dtype`` (None: ``dtype``).  ``bn_axis_name`` (:146; None, ``"data"``
or a group: parallel/mesh.py) makes every BatchNorm a SyncBatchNorm
across the processes of that group.  Convolutions and the classifier are plain
PyTorch calls: the JAX package leaves them to XLA.

Weights are random from ``seed`` in flax's distributions, not its numbers:
``he_normal`` (a normal truncated at two standard deviations, variance
2 / fan_in) for convolutions, ``lecun_normal`` and zeros for the
classifier, ones and zeros for BatchNorm; the tests load flax's weights
through convert.resnet_params_from_flax.  ``remat`` and
``stem_space_to_depth`` take only their defaults until a later slice.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_example_tpu_torch import resolve_device
from apex_example_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

# std of a unit normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0
              ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``x`` (NCHW) padded for SAME: either the symmetric padding to hand
    the op, or ``x`` padded asymmetrically and (0, 0)."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1] and value == 0.0:
        return x, (ph[0], pw[0])
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


class Conv(nn.Module):
    """Flax ``nn.Conv(use_bias=False, padding="SAME")`` over NHWC tensors;
    ``weight`` is torch's OIHW, stored in ``param_dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 strides: int = 1, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, strides, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel,
                                               dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc, pad = _pad_same(x.to(self.dtype).permute(0, 3, 1, 2),
                            self.kernel, self.strides)
        y = F.conv2d(xc, self.weight.to(self.dtype), stride=self.strides,
                     padding=pad)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``weight`` [out, in] and ``bias`` in
    ``param_dtype``, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def max_pool_same(x: torch.Tensor, kernel: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """Flax ``nn.max_pool(padding="SAME")`` over NHWC: -inf padding."""
    xc, _ = _pad_same(x.permute(0, 3, 1, 2), kernel, stride, float("-inf"))
    return F.max_pool2d(xc, kernel, stride).permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    """3x3 -> BN -> ReLU -> 3x3 -> BN, plus the (projected) residual."""

    def __init__(self, in_ch: int, filters: int, strides: int, conv, norm):
        super().__init__()
        self.Conv_0 = conv(in_ch, filters, 3, strides)
        self.SyncBatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.SyncBatchNorm_1 = norm(filters)
        self.out_ch = filters
        self.downsample = strides != 1 or in_ch != filters
        if self.downsample:
            self.downsample_conv = conv(in_ch, filters, 1, strides)
            self.downsample_bn = norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(x)))
        y = self.SyncBatchNorm_1(self.Conv_1(y))
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> BN -> ReLU -> 3x3 (stride) -> BN -> ReLU -> 1x1 (4x) -> BN,
    plus the (projected) residual."""

    def __init__(self, in_ch: int, filters: int, strides: int, conv, norm):
        super().__init__()
        self.Conv_0 = conv(in_ch, filters, 1)
        self.SyncBatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides)
        self.SyncBatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        self.SyncBatchNorm_2 = norm(filters * 4)
        self.out_ch = filters * 4
        self.downsample = strides != 1 or in_ch != filters * 4
        if self.downsample:
            self.downsample_conv = conv(in_ch, filters * 4, 1, strides)
            self.downsample_bn = norm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.SyncBatchNorm_1(self.Conv_1(y)))
        y = self.SyncBatchNorm_2(self.Conv_2(y))
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """The ResNet of ``stage_sizes`` and ``block_cls`` (see the module
    docstring); submodules carry the flax model's names (``conv_init``,
    ``bn_init``, ``Bottleneck_3``, ``fc``), so converted weights load by
    name."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 bn_dtype: Optional[torch.dtype] = None,
                 bn_io_dtype: Optional[torch.dtype] = None,
                 bn_axis_name=None,
                 bn_momentum: float = 0.1, small_stem: bool = False,
                 stem_space_to_depth: bool = False, remat: str = "none",
                 in_channels: int = 3, seed: int = 0, device="cuda"):
        super().__init__()
        if stem_space_to_depth:
            raise NotImplementedError("stem_space_to_depth is not ported "
                                      "yet (ROADMAP.md A.5)")
        if remat != "none":
            raise NotImplementedError(f"remat={remat!r} is not ported yet "
                                      f"(ROADMAP.md A.5)")
        self.num_classes, self.num_filters = num_classes, num_filters
        self.dtype, self.small_stem = dtype, small_stem
        self.bn_axis_name = bn_axis_name
        conv = functools.partial(Conv, dtype=dtype, param_dtype=param_dtype)
        norm = functools.partial(
            SyncBatchNorm, axis_name=bn_axis_name, momentum=bn_momentum,
            epsilon=1e-5,
            dtype=bn_io_dtype or dtype, stats_dtype=bn_dtype or dtype,
            param_dtype=torch.float32)
        # Built without storage, filled from the seeded generator on the
        # host, then moved: the weights depend on the seed alone.
        with torch.device("meta"):
            self.conv_init = conv(in_channels, num_filters,
                                  3 if small_stem else 7,
                                  1 if small_stem else 2)
            self.bn_init = norm(num_filters)
            self.blocks = []
            ch, n = num_filters, 0
            for i, count in enumerate(stage_sizes):
                for j in range(count):
                    strides = 2 if i > 0 and j == 0 else 1
                    block = block_cls(ch, num_filters * 2 ** i, strides,
                                      conv, norm)
                    self.add_module(f"{block_cls.__name__}_{n}", block)
                    self.blocks.append(block)
                    ch, n = block.out_ch, n + 1
            self.fc = Dense(ch, num_classes, dtype=dtype,
                            param_dtype=param_dtype)
        self.to_empty(device="cpu")
        init_resnet_weights(self, seed)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> fp32 logits [N, num_classes]."""
        x = x.to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.small_stem:
            x = max_pool_same(x)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(1, 2))
        return self.fc(x).float()


def init_resnet_weights(model: nn.Module, seed: int) -> None:
    """Flax's distributions from a CPU generator seeded with ``seed``:
    convolutions ``he_normal`` (truncated normal, variance 2 / fan_in,
    fan_in = in_ch * kh * kw), the classifier ``lecun_normal`` (variance
    1 / in) and a zero bias, BatchNorm scale one and bias zero, running
    mean zero and variance one."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if isinstance(_owner(model, name), SyncBatchNorm):
                p.fill_(1.0 if name.endswith("scale") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                fan_in = math.prod(p.shape[1:])
                gain = 1.0 if name.startswith("fc.") else 2.0
                std = math.sqrt(gain / fan_in) / _TRUNC_STD
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen)
                p.copy_(w)
        for name, b in model.named_buffers():
            b.fill_(0.0 if name.endswith("mean") else 1.0)


def _owner(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rpartition(".")[0])


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 8, 36, 3], block_cls=Bottleneck, **kw)


ARCHS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
         "resnet101": resnet101, "resnet152": resnet152}
