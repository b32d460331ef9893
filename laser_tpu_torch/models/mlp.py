"""MLP classifier (port of laser_tpu/models/mlp.py): ``init_mlp``,
``mlp_forward``, ``mlp_predict``, ``cross_entropy``, ``loss_fn`` and
``sgd_step``.

Params keep laser_tpu's layout: a list of ``{"w": (in, out), "b": (out,)}``.
Every layer is one fused GEMM kernel (bias and activation in its epilogue)
through ``linear``; ``mlp_predict`` ends in the row softmax kernel. Under
autograd ``linear`` runs the kernel without the epilogue and laser_tpu's
backward (ops/gemm/autodiff.py), so ``sgd_step`` trains through it.
``cross_entropy`` is log-softmax in plain PyTorch, as laser_tpu's is
``jax.nn.log_softmax``. ``plain=True`` routes the forward's kernels through
their plain versions. ``init_mlp`` puts its tensors on the card unless the caller
passes ``device``. ``sharded_sgd_step`` waits for the port of
laser_tpu's ``parallel/``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Union

import torch

from ..ops.gemm import linear, linear_reference
from ..ops.optim import tree_map, value_and_grad
from ..ops.vector_math import softmax
from .transformer import _generator, _normal

Params = Dict[str, torch.Tensor]


def init_mlp(seed: Union[int, torch.Generator], dims: Sequence[int], dtype=torch.float32,
             device="cuda") -> List[Params]:
    """dims = [in, hidden..., out]; He-normal weights, zero biases
    (laser_tpu's distributions, not its PRNG bits)."""
    g = _generator(seed, device)
    return [{"w": _normal(g, (d_in, d_out), math.sqrt(2.0 / d_in), dtype, device),
             "b": torch.zeros((d_out,), dtype=dtype, device=device)}
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def mlp_forward(params: List[Params], x: torch.Tensor, activation: str = "relu", *,
                plain: bool = False) -> torch.Tensor:
    """Logits: ``activation`` after every layer but the last."""
    lin = linear_reference if plain else linear
    h = x
    for i, layer in enumerate(params):
        h = lin(h, layer["w"], layer["b"], activation if i < len(params) - 1 else None)
    return h


def mlp_predict(params: List[Params], x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Class probabilities through the row softmax kernel."""
    return softmax(mlp_forward(params, x, plain=plain), plain=plain)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (int, (B,))."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def loss_fn(params: List[Params], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return cross_entropy(mlp_forward(params, x), y)


def sgd_step(params: List[Params], x: torch.Tensor, y: torch.Tensor, lr: float = 1e-2):
    """One step: loss and gradients (through ``linear``'s backward), then
    p - lr * g. Returns (new params, loss); ``params`` is not modified."""
    loss, grads = value_and_grad(loss_fn)(params, x, y)
    return tree_map(lambda p, g: p - lr * g, params, grads), loss
