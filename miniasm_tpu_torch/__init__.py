"""miniasm_tpu_torch — the PyTorch/CUDA port of miniasm_tpu.

Same input (all-vs-all read self-mappings in PAF), same flags and the same
bytes on stdout as `python -m miniasm_tpu.cli`, computed with PyTorch on
one NVIDIA GPU.  The device programs of the main path are hand-written
CUDA kernels under `csrc/` (built with nvcc on first use, bound with
ctypes); each has a plain PyTorch twin that runs when the tensors lie on
the CPU.

The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"

from .config import Opt  # noqa: F401
