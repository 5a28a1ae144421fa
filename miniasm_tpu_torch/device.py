"""Device choice for the port's entry points.

The entry points run on the GPU (`cuda`) unless the caller asks for the
CPU: `run(..., device="cpu")`, or `MINIASM_TPU_TORCH_DEVICE=cpu` for the
CLI.  Asking for `cuda` on a machine without a card raises; there is no
quiet fallback to the CPU.
"""

from __future__ import annotations

import torch

ENV = "MINIASM_TPU_TORCH_DEVICE"


def get_device(name: str | torch.device | None = None) -> torch.device:
    """Resolve a device request; None means `cuda`."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "miniasm_tpu_torch: device %r requested but no CUDA device is "
            "available (set %s=cpu or pass device='cpu' to run on the CPU)"
            % (str(dev), ENV))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % str(dev))
    return dev
