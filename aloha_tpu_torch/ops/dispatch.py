"""Where a wrapper sends its call: the plain PyTorch version or the kernel.

The port of `aloha_tpu/ops/dispatch.py:41-115` without its menu: a CPU
tensor takes the plain version, a CUDA tensor takes the kernel, anything
else raises.  There is one kernel per function and no quiet demotion to
another path (the JAX package's `_fallback` and `ALOHA_NTT_IMPL` are gone).
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; raises for mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def check(t: torch.Tensor, shape, name: str) -> None:
    """Validate a kernel operand: int64, contiguous, of the given shape."""
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on t's device, read without
    building a `torch.cuda.Stream` object (which cost 3-8 µs of a wrapper's
    host time a call on the H100's host, PERF.md §6)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
