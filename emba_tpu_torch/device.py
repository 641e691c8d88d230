"""Device helpers of the port."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs on the GPU only")
    return torch.device("cuda", 0)


def full_precision() -> None:
    """Keep f32 products in full f32: TF32 off for matmuls and cuDNN (the
    reference measured one-pass reduced precision in forming as 42x
    noisier)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
