"""Full-float32 contractions on the card.

PyTorch runs float32 convolutions through cuDNN in TF32 by default (about
three decimal digits), which would silently break the f32 contract of the
plain chain. Every f32 contraction of the port runs inside ``full_f32``.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls, then restore."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
