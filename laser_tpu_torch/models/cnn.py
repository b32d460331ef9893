"""Small CNN classifier (port of laser_tpu/models/cnn.py): conv(3x3, stride
1, pad 1) + bias + ReLU + 2x2 mean pool blocks, then a two-layer MLP head
and a softmax.

Params keep laser_tpu's layout: a list of ``{"w", "b"}`` dicts, conv weights
OIHW (c_out, C, 3, 3), then the head's (in, out) matrices. Each conv runs
``conv2d_direct`` (the planewise kernel for C * 9 <= 64, the direct kernel
otherwise), each head layer the fused GEMM kernel through ``linear``, and
``cnn_predict`` the row softmax kernel; bias, ReLU and pooling are plain
PyTorch, as laser_tpu leaves them to XLA.

``plain=True`` takes the same route through the kernels' plain versions on
any device: the reference the kernels are held against. ``init_cnn`` puts
its tensors on the card unless the caller passes ``device``. Training
(``conv2d_trainable``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Union

import torch

from ..ops.conv import conv2d_direct
from ..ops.gemm import linear, linear_reference
from ..ops.vector_math import softmax
from .transformer import _generator, _normal

Params = Dict[str, torch.Tensor]


def init_cnn(seed: Union[int, torch.Generator] = 0, *, in_channels: int = 3,
             conv_channels: Sequence[int] = (16, 32), hidden: int = 128,
             num_classes: int = 10, image_hw: int = 32, dtype=torch.float32,
             device="cuda") -> List[Params]:
    """Random params from one ``torch.Generator`` on ``device``: He-normal
    weights and zero biases, laser_tpu's distributions (not its PRNG bits)."""
    g = _generator(seed, device)
    params: List[Params] = []
    c_prev, hw = in_channels, image_hw
    for c in conv_channels:
        params.append({"w": _normal(g, (c, c_prev, 3, 3), math.sqrt(2.0 / (c_prev * 9)),
                                    dtype, device),
                       "b": torch.zeros((c,), dtype=dtype, device=device)})
        c_prev, hw = c, hw // 2
    flat = c_prev * hw * hw
    for d_in, d_out in ((flat, hidden), (hidden, num_classes)):
        params.append({"w": _normal(g, (d_in, d_out), math.sqrt(2.0 / d_in), dtype, device),
                       "b": torch.zeros((d_out,), dtype=dtype, device=device)})
    return params


def mean_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H/2, W/2) 2x2 mean pooling."""
    N, C, H, W = x.shape
    return x.reshape(N, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))


def cnn_forward(params: List[Params], x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Logits (N, num_classes) for NCHW images."""
    lin = linear_reference if plain else linear
    h = x
    for layer in params[:-2]:
        h = conv2d_direct(h, layer["w"], padding=(1, 1), plain=plain)
        h = mean_pool2x2(torch.relu(h + layer["b"][None, :, None, None]))
    h = h.reshape(h.shape[0], -1)
    h = lin(h, params[-2]["w"], params[-2]["b"], "relu")
    return lin(h, params[-1]["w"], params[-1]["b"], None)


def cnn_predict(params: List[Params], x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Class probabilities (N, num_classes)."""
    return softmax(cnn_forward(params, x, plain=plain), plain=plain)
