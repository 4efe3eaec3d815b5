"""VGG16 / InceptionV3 / DenseNet121 (PyTorch counterpart of
``autodist_tpu/models/cnn.py``): the rest of the reference's ImageNet
benchmark family, beside ``models/resnet.py``.

Same architectures, names and numerics as the flax models, built from
``resnet.Conv`` and ``resnet.BatchNorm``: the NHWC float32 batch becomes
an NCHW view of ``channels_last`` memory once, convs and the VGG
classifier's hidden Dense layers compute in ``dtype`` (bf16 on the main
path) from float32 weights, BatchNorm runs in flax's inference form from
the ``batch_stats.`` statistics and outputs float32, and the heads are
float32. Submodules carry flax's automatic names (``Conv_3``,
``BatchNorm_3``, ``ConvBN_2``, ``InceptionBlock_5``, ``DenseLayer_17``,
...), numbered per class in the order flax creates them, so
``convert.params_from_jax`` maps the variables one to one.

Pooling follows flax: ``nn.max_pool`` defaults to ``"VALID"`` (floor) and
``"SAME"`` pads with -inf, the odd pixel after (``resnet.max_pool_same``);
``nn.avg_pool(..., padding="SAME")`` counts the padded zeros
(:func:`avg_pool_same`). Channel concatenation (NHWC axis -1 in flax) is
dim 1 here, and promotes as ``jnp.concatenate`` does (DenseNet's first
block concatenates float32 features with bf16 conv outputs into
float32).
"""
import functools
import threading
from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.layers import Dense
from autodist_tpu_torch.models.resnet import (BatchNorm, Conv, max_pool_same,
                                              same_pads)


def avg_pool_same(x, kernel: int, stride: int):
    """flax ``nn.avg_pool(x, (k, k), (s, s), padding="SAME")``: zero
    padding, the odd pixel after, the padded zeros counted in each
    window's mean (``count_include_pad``)."""
    (t, b), (lft, r) = (same_pads(n, kernel, stride) for n in x.shape[2:])
    return F.avg_pool2d(F.pad(x, (lft, r, t, b)), kernel, stride)


def _conv_padding(padding):
    return 0 if padding == "VALID" else padding


class _Named(nn.Module):
    """Adds submodules under flax's automatic names: the class name and a
    counter per class, in creation order."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def add(self, module: nn.Module) -> nn.Module:
        cls = type(module).__name__
        k = self._counts.get(cls, 0)
        self._counts[cls] = k + 1
        self.add_module("%s_%d" % (cls, k), module)
        return module


# ---------------------------------------------------------------------- VGG


class VGG(_Named):
    """VGG with BatchNorm. The ``flatten`` classifier (the reference
    head) flattens the last feature map in NHWC order into the two wide
    Dense layers, so its width depends on ``image_size`` (25088 at 224);
    ``classifier="gap"`` averages it instead."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 3, 3, 3),
                 num_filters: Sequence[int] = (64, 128, 256, 512, 512),
                 num_classes: int = 1000, dense_width: int = 4096,
                 classifier: str = "flatten", dtype: Any = torch.float32,
                 image_size: int = 224):
        super().__init__()
        if classifier not in ("flatten", "gap"):
            raise ValueError("classifier must be 'flatten' or 'gap', got %r"
                             % (classifier,))
        self.apply_lock = threading.Lock()
        self.classifier = classifier
        self.stages = []
        width, size = 3, image_size
        for n, f in zip(stage_sizes, num_filters):
            stage = []
            for _ in range(n):
                stage.append((self.add(Conv(width, f, 3, dtype=dtype)),
                              self.add(BatchNorm(f))))
                width = f
            self.stages.append(stage)
            size //= 2
        flat = width * size * size if classifier == "flatten" else width
        self.add(Dense(flat, dense_width, dtype))
        self.add(Dense(dense_width, dense_width, dtype))
        self.head = Dense(dense_width, num_classes, torch.float32)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)        # NCHW view of NHWC memory
        for stage in self.stages:
            for conv, norm in stage:
                x = F.relu(norm(conv(x)))
            x = F.max_pool2d(x, 2, 2)
        if self.classifier == "flatten":
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        else:
            x = x.mean(dim=(2, 3))
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.head(x)


VGG16 = functools.partial(VGG)
VGGTiny = functools.partial(VGG, stage_sizes=(1, 1), num_filters=(8, 16),
                            dense_width=32)


# ----------------------------------------------------------------- Inception


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + relu."""

    def __init__(self, in_features: int, filters: int, kernel: int = 3,
                 stride: int = 1, padding: str = "SAME",
                 dtype: Any = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, kernel, stride,
                           _conv_padding(padding), dtype)
        self.BatchNorm_0 = BatchNorm(filters)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class InceptionBlock(_Named):
    """Mixed block: parallel 1x1 / 5x5 / double-3x3 / pool towers
    concatenated on channels."""

    def __init__(self, in_features: int, b1x1: int, b5x5: Tuple[int, int],
                 b3x3dbl: Tuple[int, int], pool: int,
                 dtype: Any = torch.float32):
        super().__init__()
        conv = functools.partial(ConvBN, dtype=dtype)
        self.t1 = [self.add(conv(in_features, b1x1, 1))]
        self.t2 = [self.add(conv(in_features, b5x5[0], 1)),
                   self.add(conv(b5x5[0], b5x5[1], 5))]
        self.t3 = [self.add(conv(in_features, b3x3dbl[0], 1)),
                   self.add(conv(b3x3dbl[0], b3x3dbl[1], 3)),
                   self.add(conv(b3x3dbl[1], b3x3dbl[1], 3))]
        self.t4 = [self.add(conv(in_features, pool, 1))]
        self.features = b1x1 + b5x5[1] + b3x3dbl[1] + pool

    def forward(self, x):
        towers = []
        for tower, y in ((self.t1, x), (self.t2, x), (self.t3, x),
                         (self.t4, avg_pool_same(x, 3, 1))):
            for layer in tower:
                y = layer(y)
            towers.append(y)
        return torch.cat(towers, dim=1)


class InceptionReduction(_Named):
    """Grid-size reduction block: strided 3x3 + double-3x3 + max-pool."""

    def __init__(self, in_features: int, b3x3: int, b3x3dbl: Tuple[int, int],
                 dtype: Any = torch.float32):
        super().__init__()
        conv = functools.partial(ConvBN, dtype=dtype)
        self.t1 = [self.add(conv(in_features, b3x3, 3, 2, "VALID"))]
        self.t2 = [self.add(conv(in_features, b3x3dbl[0], 1)),
                   self.add(conv(b3x3dbl[0], b3x3dbl[1], 3)),
                   self.add(conv(b3x3dbl[1], b3x3dbl[1], 3, 2, "VALID"))]
        self.features = b3x3 + b3x3dbl[1] + in_features

    def forward(self, x):
        towers = []
        for tower in (self.t1, self.t2):
            y = x
            for layer in tower:
                y = layer(y)
            towers.append(y)
        towers.append(F.max_pool2d(x, 3, 2))
        return torch.cat(towers, dim=1)


class Inception(_Named):
    """InceptionV3-shaped network: stem, then 3 stages of mixed blocks
    with two reductions; ``width`` scales every channel count (at least
    8), for the Tiny test config."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 blocks_per_stage: Sequence[int] = (3, 4, 2),
                 dtype: Any = torch.float32):
        super().__init__()
        self.apply_lock = threading.Lock()

        def w(f):
            return max(8, int(f * width))
        conv = functools.partial(ConvBN, dtype=dtype)
        # stem: 299x299 -> 35x35; each entry a ConvBN, or a 3x3 stride-2
        # VALID max pool (None)
        self.stem = [self.add(conv(3, w(32), 3, 2, "VALID")),
                     self.add(conv(w(32), w(32), 3, padding="VALID")),
                     self.add(conv(w(32), w(64), 3)), None,
                     self.add(conv(w(64), w(80), 1)),
                     self.add(conv(w(80), w(192), 3, padding="VALID")), None]
        c = w(192)
        blocks = []
        stages = (
            (blocks_per_stage[0], (w(64), (w(48), w(64)), (w(64), w(96)),
                                   w(64)), (w(384), (w(64), w(96)))),
            (blocks_per_stage[1], (w(192), (w(128), w(192)),
                                   (w(128), w(192)), w(192)),
             (w(320), (w(192), w(192)))),
            (blocks_per_stage[2], (w(320), (w(384), w(384)),
                                   (w(448), w(384)), w(192)), None))
        for count, widths, reduction in stages:
            for _ in range(count):
                blocks.append(self.add(InceptionBlock(c, *widths,
                                                      dtype=dtype)))
                c = blocks[-1].features
            if reduction is not None:
                blocks.append(self.add(InceptionReduction(c, *reduction,
                                                          dtype=dtype)))
                c = blocks[-1].features
        self.blocks = blocks
        self.head = Dense(c, num_classes, torch.float32)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)        # NCHW view of NHWC memory
        for layer in self.stem:
            x = F.max_pool2d(x, 3, 2) if layer is None else layer(x)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


InceptionV3 = functools.partial(Inception)
InceptionTiny = functools.partial(Inception, width=0.05,
                                  blocks_per_stage=(1, 1, 1))


# ------------------------------------------------------------------ DenseNet


class DenseLayer(nn.Module):
    """BN-relu-1x1 conv (4 x growth) -BN-relu-3x3 conv (growth), its output
    concatenated after its input."""

    def __init__(self, in_features: int, growth_rate: int,
                 dtype: Any = torch.float32):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = Conv(in_features, 4 * growth_rate, 1, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(4 * growth_rate)
        self.Conv_1 = Conv(4 * growth_rate, growth_rate, 3, dtype=dtype)

    def forward(self, x):
        y = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        y = self.Conv_1(F.relu(self.BatchNorm_1(y)))
        return torch.cat([x, y], dim=1)


class DenseNet(_Named):
    """DenseNet: dense blocks with channel-concat growth, 0.5-compression
    transitions (BN-relu-1x1 conv-2x2 average pool)."""

    def __init__(self, stage_sizes: Sequence[int] = (6, 12, 24, 16),
                 growth_rate: int = 32, num_classes: int = 1000,
                 dtype: Any = torch.float32):
        super().__init__()
        self.apply_lock = threading.Lock()
        c = 2 * growth_rate
        self.stem = (self.add(Conv(3, c, 7, 2, 3, dtype)),
                     self.add(BatchNorm(c)))
        self.stages = []
        for i, n in enumerate(stage_sizes):
            layers = []
            for _ in range(n):
                layers.append(self.add(DenseLayer(c, growth_rate, dtype)))
                c += growth_rate
            transition = None
            if i != len(stage_sizes) - 1:
                transition = (self.add(BatchNorm(c)),
                              self.add(Conv(c, c // 2, 1, dtype=dtype)))
                c //= 2
            self.stages.append((layers, transition))
        self.add(BatchNorm(c))
        self.final_norm = "BatchNorm_%d" % len(stage_sizes)
        self.head = Dense(c, num_classes, torch.float32)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)        # NCHW view of NHWC memory
        conv, norm = self.stem
        x = max_pool_same(F.relu(norm(conv(x))))
        for layers, transition in self.stages:
            for layer in layers:
                x = layer(x)
            if transition is not None:
                norm, conv = transition
                x = F.avg_pool2d(conv(F.relu(norm(x))), 2, 2)
        x = F.relu(getattr(self, self.final_norm)(x))
        return self.head(x.mean(dim=(2, 3)))


DenseNet121 = functools.partial(DenseNet)
DenseNetTiny = functools.partial(DenseNet, stage_sizes=(2, 2), growth_rate=8)
