"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if CUDA is asked
    for and absent (an entry point never falls back to the CPU).

    On CUDA this also turns TF32 off for cuDNN convolutions and cuBLAS
    matmuls (cuDNN defaults it on): the port computes in full float32,
    like the JAX reference it is held against. The flags are process
    wide.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
