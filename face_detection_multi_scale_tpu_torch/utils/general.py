"""Small shape/size utilities (copies of the JAX package's
`make_divisible` and `check_img_size`)."""

from __future__ import annotations

import math


def make_divisible(x: float, divisor: int) -> int:
    """Round ``x`` up to the nearest multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


def check_img_size(img_size: int, s: int = 32) -> int:
    """Round ``img_size`` up to a multiple of the stride ``s``."""
    return make_divisible(img_size, int(s))
