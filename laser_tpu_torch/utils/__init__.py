from .errors import (
    absolute_error,
    relative_error,
    mean_absolute_error,
    mean_relative_error,
    max_relative_error,
    round_step_down,
    round_step_up,
    cdiv,
)

__all__ = [
    "absolute_error",
    "relative_error",
    "mean_absolute_error",
    "mean_relative_error",
    "max_relative_error",
    "round_step_down",
    "round_step_up",
    "cdiv",
]
