"""Sign-split rails of a signed tensor (the part of
``repro.quant.bitplanes`` the applications use; the bit-plane split
arrives with the bitserial backend).

Sign-split (``sign_split``/``sign_merge``) represents a *signed* tensor
as a (pos, neg) pair of non-negative magnitude arrays — the same
differential-row trick the analog-LM bank planner uses — so a signed
weight can ride two unsigned stored rows.
"""
from __future__ import annotations

import numpy as np
import torch


def sign_split(values):
    """Signed array -> (pos, neg) uint8 CPU tensors with
    ``values == pos - neg`` (elementwise, one side always zero).
    Magnitudes must fit 8 bits; out-of-range input raises."""
    v = (values.cpu().numpy() if isinstance(values, torch.Tensor)
         else np.asarray(values)).astype(np.int32)
    if v.min() < -255 or v.max() > 255:
        raise ValueError("sign_split magnitudes must fit 8 bits "
                         f"(got range [{v.min()}, {v.max()}])")
    pos = np.where(v > 0, v, 0).astype(np.uint8)
    neg = np.where(v < 0, -v, 0).astype(np.uint8)
    return torch.from_numpy(pos), torch.from_numpy(neg)


def sign_merge(pos, neg):
    """Inverse of ``sign_split``: int32 signed values ``pos - neg``."""
    return (torch.as_tensor(pos).to(torch.int32)
            - torch.as_tensor(neg).to(torch.int32))
