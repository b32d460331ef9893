"""Lux, the tensor-expression layer (port of laser_tpu/lux): ``generate``
captures an expression over placeholders and lowers it onto the port's
kernels (``dsl.py``)."""

from .dsl import (LuxNode, Schedule, generate, lux_abs, lux_cos, lux_exp, lux_log, lux_max,
                  lux_relu, lux_sigmoid, lux_sin, lux_sum, lux_tanh)

__all__ = ["generate", "Schedule", "LuxNode", "lux_sin", "lux_exp", "lux_log", "lux_tanh",
           "lux_sigmoid", "lux_abs", "lux_cos", "lux_relu", "lux_sum", "lux_max"]
