"""The reference: the port's plain float32 paths, frozen, in plain PyTorch.

It imports nothing of the program and runs with TF32 off whatever the
program's run set (`exact_float32`).
"""

import torch


def exact_float32() -> None:
    """Float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
