"""8-b single-slope ADC + slicer (Fig. 2: four ADCs run in parallel).

Single-slope = slow (≈256 CTRL cycles) but tiny energy — the paper's
throughput numbers hinge on it (see energy.py timing model).  The range
(v_min, v_max) is programmable per application: mixed-signal front-ends
auto-range so the 8 bits land on the signal's dynamic range.

``v_min``/``v_max`` may be Python floats or float32 tensors.  Python
floats follow the JAX package's eager arithmetic (the span is taken in
float64, then every operand is float32); the divisor is always a float32
tensor on the signal's device, so the division is IEEE on the card as on
the CPU (a Python-float divisor would become a reciprocal multiply on
CUDA).
"""
from __future__ import annotations

import torch

from repro_torch.core.params import DimaParams


def _span(v_min, v_max, like):
    """max(v_max − v_min, 1e-9) as a float32 tensor on ``like``'s device."""
    if isinstance(v_min, torch.Tensor) or isinstance(v_max, torch.Tensor):
        hi = torch.as_tensor(v_max, dtype=torch.float32, device=like.device)
        lo = torch.as_tensor(v_min, dtype=torch.float32, device=like.device)
        return torch.clamp_min(hi - lo, 1e-9)
    return torch.tensor(max(v_max - v_min, 1e-9), dtype=torch.float32,
                        device=like.device)


def div(x, c):
    """``x / c`` for a Python number ``c`` as an IEEE quotient on every
    device (see the module note): the plain versions divide so, as the
    kernels and the JAX package do."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def window(v_range, device) -> torch.Tensor:
    """An ADC window — a (lo, hi) pair of floats or tensors, or a (..., 2)
    tensor of windows — as a float32 tensor on ``device``."""
    if isinstance(v_range, torch.Tensor):
        return v_range.to(device=device, dtype=torch.float32)
    if any(isinstance(x, torch.Tensor) for x in v_range):
        return torch.stack([torch.as_tensor(x, dtype=torch.float32)
                            .to(device).reshape(()) for x in v_range])
    return torch.tensor(v_range, dtype=torch.float32, device=device)


def adc(v, v_min, v_max, p: DimaParams):
    """volts -> code in [0, 2^bits − 1] (round half to even)."""
    full = 2 ** p.adc_bits - 1
    x = (v - v_min) / _span(v_min, v_max, v)
    return torch.clamp(torch.round(x * full), 0, full).to(torch.int32)


def dac(code, v_min, v_max, p: DimaParams):
    full = 2 ** p.adc_bits - 1
    return v_min + div(code.to(torch.float32), full) * (v_max - v_min)


def calibrate_range(volts, margin=0.05):
    """Pick (v_min, v_max) from calibration samples with headroom."""
    lo = float(torch.min(volts))
    hi = float(torch.max(volts))
    span = max(hi - lo, 1e-9)
    return lo - margin * span, hi + margin * span


def slice_binary(code, threshold_code):
    return (code >= threshold_code).to(torch.int32)


def slice_argmin(codes, axis=-1):
    return torch.argmin(codes, dim=axis)


def slice_argmax(codes, axis=-1):
    return torch.argmax(codes, dim=axis)
