"""Devices. The port's entry points run on the GPU unless the caller
names another device; without a CUDA device they raise instead of
falling back to the CPU."""

import torch


def cpu():
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", device_id)


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means the current CUDA
    device. Raises RuntimeError when a CUDA device is asked for (or
    implied) and none exists."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless a device "
                "is given (pass device='cpu' to run the plain versions)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
