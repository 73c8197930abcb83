"""DIMA MD-mode (Manhattan distance) kernel wrappers — the counterpart of
``repro/kernels/dima_md.py``.

Dual-rail functional read — BL develops f(D + P̄), BLB the complementary
f(D̄ + P) — comparator + mux pick the deeper swing, CBLP averages, ADC
converts: one launch of ``csrc/dima_md.cu`` for all (bank, query, row)
outputs.  Same contract as ``dima_dp.py``: CPU tensors take the plain
version (``ref.dima_md_ref`` + ``ref.trim_ref``), CUDA tensors launch the
kernel or raise, ``launches`` counts kernel launches only, any M >= 1.
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
launches = {"dima_md_batch": 0, "dima_md_bank_batch": 0}

#: f32 operations per (query, row) output — 39 per stored word (two
#: replica reads of 16 each, the shared cap ratio 2, comparator, select,
#: clamp and sum 5) plus 25 for vref, the means and ADC — and the trim
#: epilogue's 9
FLOPS_PER_OUTPUT = 256 * 39 + 25
FLOPS_PER_TRIM = 9

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 13 + [_I] * 3 + [_F] * 5 + [_P]


@functools.cache
def _launcher():
    fn = _build.load("dima_md").dima_md_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def plain(d, qs, col_gain, cap_eps, cmp_noise, read_noise, read_noise_b,
          cblp_noise, v_range, ep, p: DimaParams):
    """The kernel's plain PyTorch version on the bank-leading operands
    (d (NB, M, 256), noise (NB, B, M, ...), v_range (NB, 2)), on any
    device: what the wrappers compute for CPU tensors, and what the CUDA
    kernel is held to on the card.  Returns (codes, volts[, trimmed])
    each (NB, B, M)."""
    nb = d.shape[0]
    vr = v_range.reshape(nb, 1, 2)
    code, volts = ref_mod.dima_md_ref(
        d[:, None], qs, p, col_gain, cap_eps, cmp_noise, read_noise,
        read_noise_b, cblp_noise, vr)
    if ep is None:
        return code, volts
    return code, volts, ref_mod.trim_ref(code, vr, ep,
                                         pipeline_mod.md_gain(p), p)


def _run(name, d, qs, col_gain, cap_eps, cmp_noise, read_noise,
         read_noise_b, cblp_noise, v_range, ep, p: DimaParams):
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
            (cmp_noise, "cmp_noise", (nb, b, m, 2, 128), f32),
            (read_noise, "read_noise", (nb, b, m, 2, 128), f32),
            (read_noise_b, "read_noise_b", (nb, b, m, 2, 128), f32),
            (cblp_noise, "cblp_noise", (nb, b, m, 2), f32),
            (v_range, "v_range", (nb, 2), f32)):
        _build.check_operand(t, n, shape, dtype, dev)
    if ep is not None:
        _build.check_operand(ep, "ep", (b, 4), f32, dev)

    if dev.type == "cpu":
        return plain(d, qs, col_gain, cap_eps, cmp_noise, read_noise,
                     read_noise_b, cblp_noise, v_range, ep, p)
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
        cap_eps.data_ptr(), cmp_noise.data_ptr(), read_noise.data_ptr(),
        read_noise_b.data_ptr(), cblp_noise.data_ptr(), v_range.data_ptr(),
        ptr(ep), code.data_ptr(), volts.data_ptr(), ptr(trimmed),
        nb, b, m, p.delta_v_lsb, p.md_inl_beta,
        pipeline_mod.md_gain(p), float(p.dims_per_conversion),
        float(2 ** p.adc_bits - 1))
    launches[name] += 1
    return (code, volts) if ep is None else (code, volts, trimmed)


def dima_md_batch(d, qs, col_gain, cap_eps, cmp_noise, read_noise,
                  read_noise_b, cblp_noise, v_range, ep=None, *,
                  params: DimaParams = DimaParams()):
    """d (M, 256) uint8; qs (B, 256); col_gain, cap_eps (128,) f32;
    cmp/read/read_b noise (B, M, 2, 128); cblp (B, M, 2); v_range (1, 2).
    Returns (codes (B, M), volts (B, M)) in one kernel launch; ``ep``
    (B, 4) appends a fused-trim third output (see ``dima_dp_batch``)."""
    if d.dim() != 2 or any(t.dim() != 4 for t in
                           (cmp_noise, read_noise, read_noise_b)) \
            or cblp_noise.dim() != 3:
        raise ValueError("dima_md_batch wants d (M, 256), noise "
                         "(B, M, 2, 128) x3 and cblp (B, M, 2)")
    out = _run("dima_md_batch", d[None], qs, col_gain, cap_eps,
               cmp_noise[None], read_noise[None], read_noise_b[None],
               cblp_noise[None], v_range, ep, params)
    return tuple(o[0] for o in out)


def dima_md_bank_batch(d, qs, col_gain, cap_eps, cmp_noise, read_noise,
                       read_noise_b, cblp_noise, v_range, ep=None, *,
                       params: DimaParams = DimaParams()):
    """Bank-leading form: d (NB, M, 256); qs (B, 256); cmp/read noise
    (NB, B, M, 2, 128); cblp (NB, B, M, 2); v_range (NB, 2) — one ADC
    window per bank.  Returns (codes (NB, B, M), volts (NB, B, M)) from
    ONE launch; ``ep`` (B, 4) appends fused trimmed scores."""
    return _run("dima_md_bank_batch", d, qs, col_gain, cap_eps, cmp_noise,
                read_noise, read_noise_b, cblp_noise, v_range, ep, params)
