"""CNN model family: ResNet-18/34/50/101 and VGG-16/19.

Counterpart of ``byteps_tpu/models/cnn.py`` (flax.linen), the models behind
the JAX package's second benchmark row.  The public layout is the JAX
package's: images are NHWC, and every module, parameter and statistic
carries its flax name (``conv_init``, ``bn_init``,
``BottleneckResNetBlock_3.Conv_1.kernel``, ``Dense_0.bias``, ...), so
``cnn_variables(model)`` is the flax variable tree (``params`` and
``batch_stats``) of the model's own tensors, flattened in flax's order, and
``params_from_numpy`` loads a flax tree as numpy arrays.  Inside, the
convolutions run NCHW through cuDNN (or the CPU), with kernels stored
OIHW.

What has to match flax, and would not by default:

  - ``"SAME"`` padding is asymmetric on even inputs: a 3x3 stride-2 conv
    (every downsampling bottleneck) and the 3x3/2 max-pool after
    ``conv_init`` pad (0, 1), not torch's (1, 1).  The pads are explicit
    here: zeros for the convs, -inf for the pool.
  - VGG's first ``Dense`` reads the feature map flattened in (h, w, c)
    order.
  - BatchNorm: epsilon 1e-5; flax's momentum 0.9 is torch's 0.1; the batch
    variance is the biased one (flax's), in the update of the running
    variance too; the last BatchNorm scale of each residual block starts
    at zero.

``dtype`` is the compute dtype (parameters stay float32, as in the flax
models); batch statistics are computed in float32 and the classifier
runs in float32.  ``cnn_loss_fn`` runs the BatchNorms on their running
statistics, as the JAX package's loss does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import DeviceLike, resolve_device

Tree = Any
BN_EPS = 1e-5
BN_MOMENTUM = 0.9      # flax's: running = 0.9 running + 0.1 batch


def _same_pad(size: int, k: int, s: int):
    """Flax's (and XLA's) "SAME" padding of one spatial axis: the total
    that makes the output ceil(size / s), the odd element at the end."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """nn.Conv: kernel HWIO in flax, stored OIHW; "SAME" padding unless
    ``padding`` gives (low, high) per spatial axis."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[Sequence[int]] = None,
                 use_bias: bool = False):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))
        # flax's default: lecun_normal (fan_in, a truncated normal)
        nn.init.trunc_normal_(self.kernel, std=1.0 / math.sqrt(cin * k * k)
                              / 0.87962566103423978)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is None:
            ph = _same_pad(x.shape[2], self.k, self.stride)
            pw = _same_pad(x.shape[3], self.k, self.stride)
        else:
            ph = pw = tuple(self.padding)
        if any(ph) or any(pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        w = self.kernel.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, stride=self.stride)


class BatchNorm(nn.Module):
    """nn.BatchNorm over the channel axis: ``scale``/``bias`` parameters,
    ``mean``/``var`` running statistics (flax's ``batch_stats``)."""

    def __init__(self, c: int, zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(c) if zero_scale
                                  else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = (xf * xf).mean((0, 2, 3)) - mean * mean
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
        y = y * self.scale.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class Dense(nn.Module):
    """nn.Dense: kernel [in, out] as in flax."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        nn.init.trunc_normal_(self.kernel, std=1.0 / math.sqrt(cin)
                              / 0.87962566103423978)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        if cin != filters or stride != 1:
            self.conv_proj = Conv(cin, filters, 1, stride)
            self.norm_proj = BatchNorm(filters)
        self.cout = filters

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True)
        if cin != filters * 4 or stride != 1:
            self.conv_proj = Conv(cin, filters * 4, 1, stride)
            self.norm_proj = BatchNorm(filters * 4)
        self.cout = filters * 4

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, padding=(3, 3))
        self.bn_init = BatchNorm(num_filters)
        cin, n = num_filters, 0
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                block = block_cls(cin, num_filters * 2 ** i,
                                  2 if i > 0 and j == 0 else 1)
                self.add_module(f"{block_cls.__name__}_{n}", block)
                cin, n = block.cout, n + 1
        self.num_blocks = n
        self.block_name = block_cls.__name__
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC images -> float32 logits."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        ph = _same_pad(x.shape[2], 3, 2)
        pw = _same_pad(x.shape[3], 3, 2)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2)
        for n in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{n}")(x)
        return self.Dense_0(x.mean((2, 3)).float())


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H * W * C] in flax's (h, w, c) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class VGG(nn.Module):
    def __init__(self, cfg: Sequence, num_classes: int = 1000,
                 image_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cfg = list(cfg)
        cin, n, hw = 3, 0, image_size
        for v in self.cfg:
            if v == "M":
                hw //= 2
            else:
                self.add_module(f"Conv_{n}", Conv(cin, v, 3, padding=(1, 1),
                                                  use_bias=True))
                cin, n = v, n + 1
        self.Dense_0 = Dense(hw * hw * cin, 4096)
        self.Dense_1 = Dense(4096, 4096)
        self.Dense_2 = Dense(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        n = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{n}")(x))
                n += 1
        x = F.relu(self.Dense_0(_flatten(x)))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x.float())


_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]
_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

_CNN_TABLE = {
    "resnet18": lambda **kw: ResNet([2, 2, 2, 2], ResNetBlock, **kw),
    "resnet34": lambda **kw: ResNet([3, 4, 6, 3], ResNetBlock, **kw),
    "resnet50": lambda **kw: ResNet([3, 4, 6, 3], BottleneckResNetBlock,
                                    **kw),
    "resnet101": lambda **kw: ResNet([3, 4, 23, 3], BottleneckResNetBlock,
                                     **kw),
    "vgg16": lambda **kw: VGG(_VGG16_CFG, **kw),
    "vgg19": lambda **kw: VGG(_VGG19_CFG, **kw),
}
CNN_NAMES = tuple(_CNN_TABLE)


def create_cnn(name: str, num_classes: int = 1000,
               dtype: torch.dtype = torch.float32, device: DeviceLike = None,
               seed: int = 0, **kw) -> nn.Module:
    """The named model with random weights from ``seed``, on ``device``
    (default CUDA).  VGG takes ``image_size`` (default 224): its first
    Dense reads the flattened final feature map."""
    if name not in _CNN_TABLE:
        raise ValueError(
            f"unknown cnn {name!r}; options: {sorted(_CNN_TABLE)}")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = _CNN_TABLE[name](num_classes=num_classes, dtype=dtype, **kw)
    return model.to(dev)


def cnn_variables(model: nn.Module) -> Dict[str, Tree]:
    """The flax variable tree of the model's own tensors: {"params": ...,
    "batch_stats": ...}, nested by module name.  ``tree_leaves`` of its
    "params" is flax's leaf order (sorted names)."""
    out: Dict[str, Tree] = {"params": {}}

    def put(root: Dict, path: str, t: torch.Tensor) -> None:
        *mods, leaf = path.split(".")
        for m in mods:
            root = root.setdefault(m, {})
        root[leaf] = t

    for path, p in model.named_parameters():
        put(out["params"], path, p)
    stats = dict(model.named_buffers())
    if stats:
        out["batch_stats"] = {}
        for path, b in stats.items():
            put(out["batch_stats"], path, b)
    return out


def params_from_numpy(model: nn.Module, variables: Dict[str, Tree]) -> None:
    """Load a flax variable tree (``params`` and ``batch_stats``, numpy
    arrays) into ``model`` in place: conv kernels HWIO -> OIHW, the rest
    as they are.  Every tensor of the model must be in the tree, with its
    shape."""
    mine = cnn_variables(model)

    def walk(dst: Tree, src: Tree, path: str) -> None:
        if isinstance(dst, dict):
            if set(dst) != set(src):
                raise ValueError(f"{path or 'variables'}: the model has "
                                 f"{sorted(dst)}, the tree {sorted(src)}")
            for key in dst:
                walk(dst[key], src[key], f"{path}.{key}" if path else key)
            return
        arr = np.asarray(src, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {arr.shape} for "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    for col in mine:
        walk(mine[col], variables[col], col)


def cnn_loss_fn(model: nn.Module):
    """``loss(params, batch)``: softmax cross-entropy of ``model`` on
    ``batch = (images NHWC, labels)``, BatchNorms on their running
    statistics (the JAX package's ``train=False``).  ``params`` is the
    tree the optimizer was built over (``cnn_variables(model)["params"]``
    or the model's parameters); the model holds those tensors."""
    def loss(params, batch):
        del params
        was = model.training
        model.eval()
        try:
            images, labels = batch
            logits = model(images)
        finally:
            model.train(was)
        return F.cross_entropy(logits.float(), labels)
    return loss
