"""Global dtype policy of the PyTorch port.

Same policy as the JAX package (`rpt_tpu/dtypes.py:81-94`): the reference
computes in f64, the port computes geometry and radiometry in f32 with
scale-aware epsilons (see `rpt_tpu_torch.intersect`). Integer indices are
int64 on the torch side (torch's native index type).

TF32 is switched off explicitly: a float32 matrix product or convolution
on the card must keep full float32 precision, as the reference's results
are compared at f32 tolerances.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Float dtype used for all geometry/radiometry computation.
DTYPE = torch.float32

#: "No hit" time (reference: f64::INFINITY, `shape.rs:87`).
INF = float("inf")

#: float32 machine epsilon (the on-plane guards scale by it).
EPS = float(torch.finfo(DTYPE).eps)


def resolve_device(device) -> torch.device:
    """The explicit device of a renderer or compiled scene. A CUDA device
    without a usable card raises: the port never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is False"
        )
    return dev
