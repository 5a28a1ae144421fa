"""Device choice for the port's entry points.

The entry points run on the GPU (`cuda`) unless the caller asks for the
CPU: `run(..., device="cpu")`, or `MINIASM_TPU_TORCH_DEVICE=cpu` for the
CLI.  Asking for `cuda` on a machine without a card raises; there is no
quiet fallback to the CPU.
"""

from __future__ import annotations

import threading

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


# each thread's pinned staging block for to_host, kept for the process
# and grown as needed: a process pins host memory once, not once a call
# and size class
_STAGE = threading.local()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t on the CPU in one device-to-host copy, through pinned memory, and
    the stream synchronized; a CPU tensor comes back as it is.  The copy
    lands in the calling thread's staging block: it holds until that
    thread's next to_host call, so the caller copies out what it keeps."""
    if t.device.type != "cuda":
        return t
    nbytes = t.numel() * t.element_size()
    block = getattr(_STAGE, "block", None)
    if block is None or block.numel() < nbytes:
        # a power of two, as the caching host allocator rounds it, so that
        # a slightly larger copy later (the -p paf tables) still fits
        block = torch.empty(1 << max(20, (nbytes - 1).bit_length()),
                            dtype=torch.uint8, pin_memory=True)
        _STAGE.block = block
    host = block[:nbytes].view(t.dtype).view(t.shape)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host
