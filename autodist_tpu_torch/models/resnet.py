"""ResNet family (PyTorch counterpart of ``autodist_tpu/models/resnet.py``):
ResNet-18/50/101 and a tiny test config.

Same architecture and numerics as the flax model. The batch is the JAX
one (NHWC float32 images ``[B, H, W, 3]``, int32 labels); the model
permutes it once into NCHW logical tensors whose memory stays
``channels_last`` (NHWC), the layout cuDNN's tensor-core convolutions
take. Convs compute in ``dtype`` (bf16 on the main path) with float32
weights cast at use; BatchNorm computes and outputs float32, so the
residual stream, the relus, the pooled features and the head are float32
and each conv casts its input down.

BatchNorm runs from the statistics in the params mapping (flax's
inference mode, ``use_running_average``, which the JAX loss uses): its
``mean``/``var`` are the ``batch_stats.`` names
(``model_item.BATCH_STATS_PREFIX``) that ``ModelItem``'s default filter
keeps from training, so they never move, while ``weight``/``bias`` (flax
``scale``/``bias``) train.

flax's ``"SAME"`` padding puts the odd pixel after: a 3x3 stride-2 conv
or the stride-2 max pool pads 0 before and 1 after at an even size (56 ->
28). :class:`Conv` and :func:`max_pool_same` pad so, explicitly.
"""
import functools
import inspect
import threading
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.model_item import BATCH_STATS_PREFIX
from autodist_tpu_torch.models.layers import (Dense, _param, apply,
                                              lecun_normal_)


def same_pads(size: int, kernel: int, stride: int):
    """flax/XLA ``"SAME"`` padding of one spatial dim: ``(before, after)``
    with the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: ``weight [out, in, kh, kw]`` float32,
    computed in ``dtype`` on ``channels_last`` tensors. ``padding`` is
    ``"SAME"`` or an int padded on both sides."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding="SAME", dtype=torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.weight = _param(features, in_features, kernel, kernel)

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        if self.padding != "SAME":
            return F.conv2d(x, w, stride=self.stride, padding=self.padding)
        (t, b), (lft, r) = (same_pads(n, self.kernel, self.stride)
                            for n in x.shape[2:])
        if (t, lft) == (b, r):
            return F.conv2d(x, w, stride=self.stride, padding=(t, lft))
        return F.conv2d(F.pad(x, (lft, r, t, b)), w, stride=self.stride)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: pads with
    -inf, the odd pixel after."""
    (t, b), (lft, r) = (same_pads(n, kernel, stride) for n in x.shape[2:])
    x = F.pad(x, (lft, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, dtype=float32)`` over
    the channel dim of an NCHW tensor: ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` in float32, flax's order, with flax's epsilon 1e-5
    (the layer norms' is 1e-6). ``zero_init`` marks the last norm of a
    block, whose scale starts at 0."""

    EPS = 1e-5

    def __init__(self, features: int, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = _param(features)
        self.bias = _param(features)
        self.mean = _param(features)
        self.var = _param(features)

    def forward(self, x):
        c = (1, -1, 1, 1)
        mul = torch.rsqrt(self.var + self.EPS) * self.weight
        return (x.float() - self.mean.view(c)) * mul.view(c) + \
            self.bias.view(c)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, stride, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, zero_init=True)
        if stride != 1 or in_features != filters:
            self.conv_proj = Conv(in_features, filters, 1, stride,
                                  dtype=dtype)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, zero_init=True)
        if stride != 1 or in_features != out:
            self.conv_proj = Conv(in_features, out, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """``forward(image)``: NHWC float32 images -> float32 logits. Blocks are
    named as flax names them (``BasicBlock_0``, ``BottleneckBlock_3``,
    counted over all stages). A block projects its residual where its
    stride or width changes, where flax's block finds the shapes
    differ."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: Any = torch.float32):
        super().__init__()
        self.apply_lock = threading.Lock()
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        blocks, width = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(width, filters,
                                        2 if i > 0 and j == 0 else 1, dtype))
                width = filters * block_cls.expansion
        for k, block in enumerate(blocks):
            self.add_module("%s_%d" % (block_cls.__name__, k), block)
        self.num_blocks = len(blocks)
        self.block_name = block_cls.__name__
        self.head = Dense(width, num_classes, torch.float32)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)        # NCHW view of NHWC memory
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x)
        for k in range(self.num_blocks):
            x = getattr(self, "%s_%d" % (self.block_name, k))(x)
        return self.head(x.mean(dim=(2, 3)))


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
# a tiny config for tests
ResNetTiny = functools.partial(ResNet, stage_sizes=[1, 1],
                               block_cls=BasicBlock, num_filters=8)


def _module_names(params: dict) -> dict:
    """The params mapping under the module's own names: ``batch_stats.X``
    -> ``X`` (the tensors themselves, so gradients reach the caller's)."""
    n = len(BATCH_STATS_PREFIX)
    return {k[n:] if k.startswith(BATCH_STATS_PREFIX) else k: v
            for k, v in params.items()}


def init_params(model: ResNet, seed: int = 0) -> dict:
    """A float32 ``{name: tensor}`` init on the CPU from a seeded
    ``torch.Generator``, in flax's distributions: conv and head weights
    ``lecun_normal`` (fan_in = in x kh x kw), zero head bias, BatchNorm
    scale 1 (0 for the last norm of each block), bias 0, mean 0, var 1."""
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for mod_name, mod in model.named_modules():
        prefix = mod_name + "."
        if isinstance(mod, Conv):
            shape = tuple(mod.weight.shape)
            params[prefix + "weight"] = lecun_normal_(
                torch.empty(shape), int(np.prod(shape[1:])), gen)
        elif isinstance(mod, Dense):
            shape = tuple(mod.weight.shape)
            params[prefix + "weight"] = lecun_normal_(torch.empty(shape),
                                                      shape[1], gen)
            params[prefix + "bias"] = torch.zeros(shape[0])
        elif isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            params[prefix + "weight"] = (torch.zeros(c) if mod.zero_init
                                         else torch.ones(c))
            params[prefix + "bias"] = torch.zeros(c)
            params[BATCH_STATS_PREFIX + prefix + "mean"] = torch.zeros(c)
            params[BATCH_STATS_PREFIX + prefix + "var"] = torch.ones(c)
    return params


def make_train_setup(model_cls=ResNet50, num_classes: int = 1000,
                     image_size: int = 224, batch_size: int = 64,
                     dtype=torch.bfloat16, seed: int = 0):
    """``(loss_fn, params, example_batch, apply_fn)`` as in the JAX module:
    softmax cross-entropy over float32 logits, averaged over the batch,
    with BatchNorm in inference mode (statistics from the params). Also
    the setup of ``models/cnn.py``'s models; a model whose width depends
    on the image (VGG's ``flatten`` classifier) gets ``image_size``."""
    kw = {}
    if "image_size" in inspect.signature(model_cls).parameters:
        kw["image_size"] = image_size
    with torch.device("meta"):
        model = model_cls(num_classes=num_classes, dtype=dtype, **kw)
    params = init_params(model, seed)

    def forward(p, image):
        return apply(model, _module_names(p), torch.as_tensor(image))

    def loss_fn(params, batch):
        logits = forward(params, batch["image"])
        logp = torch.log_softmax(logits, dim=-1)
        labels = torch.as_tensor(batch["label"]).long()
        return -torch.gather(logp, -1, labels[:, None]).mean()

    npr = np.random.RandomState(seed)
    example_batch = {
        "image": npr.randn(batch_size, image_size, image_size,
                           3).astype(np.float32),
        "label": npr.randint(0, num_classes, (batch_size,)).astype(np.int32),
    }
    return loss_fn, params, example_batch, forward

