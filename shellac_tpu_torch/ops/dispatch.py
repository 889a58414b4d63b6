"""Device resolution for the port's entry points.

The port's kernels run on an NVIDIA Hopper card. Entry points default to
the card and raise when there is none; they run on the CPU only when the
caller asks for it, and then every kernel wrapper takes its plain PyTorch
version because the tensors it is given lie on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: "cuda" unless told otherwise.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is present; there is no silent CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; have cuda, cpu")


def check_on(device: torch.device, **tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor lies on `device`."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(
                f"{name} is on {t.device}, expected {device}"
            )


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would record a call to an inference-only kernel.

    The decode kernels have no backward: a launch through ctypes writes a
    fresh tensor with no grad_fn, so a gradient through it would be lost
    without a word. Grad mode on and any input requiring grad is refused.
    """
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} is inference-only (its kernel has no backward); call "
            "it under torch.no_grad() or on tensors that do not require grad"
        )


def copy_from_host(dst: torch.Tensor, values) -> None:
    """Write host `values` (numpy or a list) into the device tensor `dst`
    without blocking the host.

    A plain host-to-card copy from pageable memory returns only once
    every kernel queued before it has run, which would wait out a decode
    window in flight. On the card the values go through pinned memory
    with `non_blocking=True`, in stream order; the pinned block comes
    from torch's caching host allocator, which keeps it until the copy
    has run. On the CPU it is a plain copy.
    """
    src = torch.as_tensor(values, dtype=dst.dtype)
    if dst.is_cuda:
        dst.copy_(src.reshape(dst.shape).pin_memory(), non_blocking=True)
    else:
        dst.copy_(src.reshape(dst.shape))
