"""Non-equivariant canonicalization networks (vector-output backbones).

Counterpart of `equiadapt_tpu/images/networks/conv.py`: NHWC images in,
(B, out_vector_size) vectors out, for the orbit-scoring (optimized)
canonicalizers. Submodules carry the names Flax gives their counterparts
(`Conv_0`, `BatchNorm_2`, `Dense_0`, `ResNet_0`), so
`utils.jax_weights.load_flax_variables` carries weights across by path.

Flax infers a layer's input width at the first call; torch fixes it at
construction, so `ConvNetwork` takes the (H, W) of its input images
(`input_size`), which sets the width of its head.

`training` is an argument, as in the JAX package, and the module mode is
not read: in training the BatchNorms normalize with batch statistics and
update their running ones with Flax's semantics, and `ConvNetwork`'s
dropout draws its mask from `generator` (`common/layers.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import BatchNorm, Dropout
from equiadapt_tpu_torch.models.resnet import ResNet18, WideResNet50, WideResNet101

Tensor = torch.Tensor

__all__ = ["ConvNetwork", "ResNet18Network", "WideResNet50Network",
           "WideResNet101Network"]


class ConvNetwork(nn.Module):
    """Strided conv stack with BatchNorm + GELU and a fully connected head.

    Layer i: a k x k convolution with stride 2; layer 0 maps in -> out
    channels with no padding, every (i % 3 == 2) layer doubles the width with
    padding 1, the others keep the width with no padding. Then BatchNorm and
    the tanh-approximate GELU (Flax's `nn.gelu`). Head: the feature map
    flattened in (H, W, C) order, as Flax flattens NHWC, then BatchNorm,
    dropout(0.5), ReLU and Dense(out_vector_size).

    `input_size`: the (H, W) (or the side) of the input images. `dtype` sets
    the parameters' and the computation's dtype.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_layers: int = 2, out_vector_size: int = 128, *,
                 input_size: Union[int, Tuple[int, int]],
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        h, w = (input_size, input_size) if isinstance(input_size, int) else input_size
        self.num_layers = num_layers
        self.dtype = dtype
        k = kernel_size
        c_in, width = in_channels, out_channels
        for i in range(num_layers):
            pad = 0
            if i > 0 and i % 3 == 2:
                width *= 2
                pad = 1
            setattr(self, f"Conv_{i}",
                    nn.Conv2d(c_in, width, k, 2, pad, device=device))
            setattr(self, f"BatchNorm_{i}", BatchNorm(width, device=device))
            h = (h + 2 * pad - k) // 2 + 1
            w = (w + 2 * pad - k) // 2 + 1
            c_in = width
        if h < 1 or w < 1:
            raise ValueError(f"input_size {input_size} is too small for "
                             f"{num_layers} layers of kernel {k}")
        features = width * h * w
        setattr(self, f"BatchNorm_{num_layers}", BatchNorm(features, device=device))
        self.Dropout_0 = Dropout(0.5)
        self.Dense_0 = nn.Linear(features, out_vector_size, device=device)
        self.to(dtype)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """NHWC images -> (B, out_vector_size); `generator` draws the
        dropout mask in training (on x's device)."""
        y = x.permute(0, 3, 1, 2).to(self.dtype).contiguous()
        for i in range(self.num_layers):
            y = getattr(self, f"Conv_{i}")(y)
            y = F.gelu(getattr(self, f"BatchNorm_{i}")(y, training),
                       approximate="tanh")
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)  # NHWC flatten
        y = getattr(self, f"BatchNorm_{self.num_layers}")(y, training)
        y = torch.relu(self.Dropout_0(y, training, generator))
        return self.Dense_0(y)


class _ResNetHead(nn.Module):
    """A ResNet backbone's pooled features -> Dense(out_vector_size)."""

    backbone = None
    features = 0

    def __init__(self, out_vector_size: int = 128,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.ResNet_0 = self.backbone(num_classes=None, dtype=dtype, device=device)
        self.Dense_0 = nn.Linear(self.features, out_vector_size, device=device,
                                 dtype=dtype)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        return self.Dense_0(self.ResNet_0(x, training=training))


class ResNet18Network(_ResNetHead):
    """ResNet-18 backbone with a replaced head -> out_vector_size."""

    backbone = ResNet18
    features = 512


class WideResNet50Network(_ResNetHead):
    """Wide-ResNet-50-2 backbone with a replaced head."""

    backbone = WideResNet50
    features = 2048


class WideResNet101Network(_ResNetHead):
    """Wide-ResNet-101-2 backbone with a replaced head."""

    backbone = WideResNet101
    features = 2048
