"""Device and dtype resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on. ``None`` means the CUDA card;
    the CPU is used only when the caller names it. Asking for CUDA where
    no card is present raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch paths on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A dtype name ("bfloat16", "float32", "float16") or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; known: "
                         f"{sorted(DTYPES)}") from None
