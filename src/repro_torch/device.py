"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a :class:`torch.device` (CUDA with its index), raising
    when it names CUDA on a machine without it.  Nothing here picks a
    device on its own: the caller asks for ``"cpu"`` explicitly to run the
    plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N": give the device its index so that
        # comparisons with a tensor's device hold
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU): a host clock
    read after it times the device's work, not its enqueue."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
