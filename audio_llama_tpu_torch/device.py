"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. Raises when no card is present and the caller
    did not ask for the CPU explicitly: the port never quietly runs its main
    path on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "audio_llama_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded `torch.Generator` on `device` (random init and sampling take
    explicit generators, never the global RNG)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen
