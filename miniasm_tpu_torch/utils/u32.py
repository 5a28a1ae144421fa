"""uint32 on torch: the JAX programs keep uint32 columns, which torch's CPU
kernels cannot compare or clamp.  The port holds them as their int32 bit
patterns and widens to int64 where a uint32 compare is needed."""

from __future__ import annotations

import torch


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its uint32 value, held in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> its int32 bit pattern."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)
