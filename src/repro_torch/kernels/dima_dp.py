"""DIMA DP-mode kernel wrappers — the counterpart of
``repro/kernels/dima_dp.py``.

The analog pipeline (MR-FR → BLP capacitive multiply → CBLP charge share
→ ADC, optional fused trim) of every stored row against every query is
one launch of the CUDA kernel ``csrc/dima_dp.cu`` (one warp per output;
see the source for what bounds it).  ``dima_dp_batch`` is the
query-batched form, ``dima_dp_bank_batch`` the bank-leading form of the
multibank backend; both launch the same kernel.

A wrapper given CPU tensors computes the kernel's plain version
(``ref.dima_dp_ref`` + ``ref.trim_ref``); given CUDA tensors it launches
the kernel — building it at first use — or raises.  ``launches`` counts
kernel launches per wrapper, nothing else.  Unlike the Pallas kernel the
CUDA kernel has no 128-row block: any ``M >= 1`` is accepted (the ops
layer still pads to 128 rows so its noise layout matches the JAX
package's).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.params import DimaParams
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_mod

#: kernel launches by each wrapper (calls on CPU tensors do not count)
launches = {"dima_dp_batch": 0, "dima_dp_bank_batch": 0}

#: f32 operations per (query, row) output — 34 per stored word (transfer
#: 2×4, merge 6, gain + noise 2, two multiplier rails 2×8, two sums) plus
#: 23 for the means, rail merge and ADC — and the trim epilogue's 9
FLOPS_PER_OUTPUT = 256 * 34 + 23
FLOPS_PER_TRIM = 9

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 13 + [_I] * 3 + [_F] * 6 + [_P]


@functools.cache
def _launcher():
    fn = _build.load("dima_dp").dima_dp_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def plain(d, qs, col_gain, cap_eps, mult_gain, mult_off, read_noise,
          cblp_noise, v_range, ep, p: DimaParams):
    """The kernel's plain PyTorch version on the bank-leading operands
    (d (NB, M, 256), noise (NB, B, M, ...), v_range (NB, 2)), on any
    device: what the wrappers compute for CPU tensors, and what the CUDA
    kernel is held to on the card.  Returns (codes, volts[, trimmed])
    each (NB, B, M)."""
    nb = d.shape[0]
    vr = v_range.reshape(nb, 1, 2)
    code, volts = ref_mod.dima_dp_ref(
        d[:, None], qs, p, col_gain, cap_eps, mult_gain, mult_off,
        read_noise, cblp_noise, vr)
    if ep is None:
        return code, volts
    return code, volts, ref_mod.trim_ref(code, vr, ep,
                                         pipeline_mod.dp_gain(p), p)


def _run(name, d, qs, col_gain, cap_eps, mult_gain, mult_off, read_noise,
         cblp_noise, v_range, ep, p: DimaParams):
    """d (NB, M, 256); noise (NB, B, M, ...); v_range (NB, 2) ->
    (codes, volts[, trimmed]) each (NB, B, M)."""
    if d.dim() != 3 or qs.dim() != 2:
        raise ValueError(f"d must be (NB, M, 256) and qs (B, 256); got "
                         f"{tuple(d.shape)} and {tuple(qs.shape)}")
    nb, m, b = d.shape[0], d.shape[1], qs.shape[0]
    if min(nb, m, b) < 1:
        raise ValueError(f"empty operand: NB={nb}, B={b}, M={m}")
    dev = d.device
    f32 = torch.float32
    for t, n, shape, dtype in (
            (d, "d", (nb, m, 256), torch.uint8),
            (qs, "qs", (b, 256), torch.uint8),
            (col_gain, "col_gain", (128,), f32),
            (cap_eps, "cap_eps", (128,), f32),
            (mult_gain, "mult_gain", (2, 128), f32),
            (mult_off, "mult_off", (2, 128), f32),
            (read_noise, "read_noise", (nb, b, m, 2, 128), f32),
            (cblp_noise, "cblp_noise", (nb, b, m, 2, 2), f32),
            (v_range, "v_range", (nb, 2), f32)):
        _build.check_operand(t, n, shape, dtype, dev)
    if ep is not None:
        _build.check_operand(ep, "ep", (b, 4), f32, dev)

    if dev.type == "cpu":
        return plain(d, qs, col_gain, cap_eps, mult_gain, mult_off,
                     read_noise, cblp_noise, v_range, ep, p)
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")

    code = torch.empty((nb, b, m), dtype=torch.int32, device=dev)
    volts = torch.empty((nb, b, m), dtype=f32, device=dev)
    trimmed = None if ep is None else torch.empty((nb, b, m), dtype=f32,
                                                  device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.launch(
        _launcher(), name, dev,
        d.data_ptr(), qs.data_ptr(), col_gain.data_ptr(),
        cap_eps.data_ptr(), mult_gain.data_ptr(), mult_off.data_ptr(),
        read_noise.data_ptr(), cblp_noise.data_ptr(), v_range.data_ptr(),
        ptr(ep), code.data_ptr(), volts.data_ptr(), ptr(trimmed),
        nb, b, m, p.delta_v_lsb, p.inl_beta, p.mult_beta,
        pipeline_mod.dp_gain(p), float(p.dims_per_conversion),
        float(2 ** p.adc_bits - 1))
    launches[name] += 1
    return (code, volts) if ep is None else (code, volts, trimmed)


def dima_dp_batch(d, qs, col_gain, cap_eps, mult_gain, mult_off, read_noise,
                  cblp_noise, v_range, ep=None, *,
                  params: DimaParams = DimaParams()):
    """Query-batched form: d (M, 256) uint8; qs (B, 256) uint8; chip
    arrays col_gain, cap_eps (128,), mult_gain, mult_off (2, 128) f32;
    read_noise (B, M, 2, 128); cblp_noise (B, M, 2, 2) [row, cycle, rail];
    v_range (1, 2) f32.  Returns (codes (B, M) int32, volts (B, M) f32) —
    one kernel launch.  ``ep`` (B, 4) f32 rows ``[c0, c1, c2, Σq_b]``
    append a fused-trim output ``trimmed`` (B, M) f32, computed as
    ``pipeline.trim_epilogue``."""
    if d.dim() != 2 or read_noise.dim() != 4 or cblp_noise.dim() != 4:
        raise ValueError("dima_dp_batch wants d (M, 256), read_noise "
                         "(B, M, 2, 128), cblp_noise (B, M, 2, 2)")
    out = _run("dima_dp_batch", d[None], qs, col_gain, cap_eps, mult_gain,
               mult_off, read_noise[None], cblp_noise[None], v_range, ep,
               params)
    return tuple(o[0] for o in out)


def dima_dp_bank_batch(d, qs, col_gain, cap_eps, mult_gain, mult_off,
                       read_noise, cblp_noise, v_range, ep=None, *,
                       params: DimaParams = DimaParams()):
    """Bank-leading form: d (NB, M, 256) uint8 — one multibank shard per
    leading index; qs (B, 256); read_noise (NB, B, M, 2, 128); cblp_noise
    (NB, B, M, 2, 2); v_range (NB, 2) — one ADC window per bank.  Returns
    (codes (NB, B, M) int32, volts (NB, B, M) f32) from ONE launch;
    ``ep`` (B, 4) appends fused trimmed scores (NB, B, M)."""
    return _run("dima_dp_bank_batch", d, qs, col_gain, cap_eps, mult_gain,
                mult_off, read_noise, cblp_noise, v_range, ep, params)
