"""Wrappers around the DIMA kernels: padding to the 128-row block, the
chip record as kernel operands, and generator-based noise expansion — so
callers never see the explicit-noise kernel signature.  The counterpart
of ``repro/kernels/ops.py`` for the DIMA kernels.

Every op takes its device from the stored words ``d``: on the CPU the
kernel wrappers compute the plain versions, on the card they launch the
CUDA kernels.

Noise rule (in place of the JAX package's ``split``/``fold_in``; see
``core.noise``):

* ``_expand_noise(gen, …)`` — one read: the noise arrays are drawn from
  ``gen`` in operand order (dp: read, cblp; md: cmp, read, read_b, cblp);
* ``_batch_noise`` — query ``j`` of a batch draws as ``_expand_noise``
  from ``fold_in(gen, j)``;
* ``_stack_bank_noise`` — bank ``b`` draws from ``fold_in(gen, offset +
  b)`` with the matvec (``_expand_noise``) or matmat (``_batch_noise``)
  layout.

So a query batch is reproducible query by query, and one fused bank
launch draws bank for bank what per-bank launches with those children
would.  With ``gen=None`` every array is zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import adc as adc_mod
from repro_torch.core import noise as noise_mod
from repro_torch.core.params import DimaParams
from repro_torch.core.pipeline import dp_gain, md_gain
from repro_torch.kernels.dima_dp import dima_dp_bank_batch as _dp_bank
from repro_torch.kernels.dima_dp import dima_dp_batch as _dp_batch
from repro_torch.kernels.dima_md import dima_md_bank_batch as _md_bank
from repro_torch.kernels.dima_md import dima_md_batch as _md_batch


def _pad_to(x, mult, axis):
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]   # last dim first
    return F.pad(x, widths)


def _expand_noise(gen, p: DimaParams, M, kind, device):
    """Per-read dynamic noise arrays for the analog kernels."""
    if gen is None:
        z = lambda *s: torch.zeros(s, device=device)
        if kind == "dp":
            return z(M, 2, 128), z(M, 2, 2)
        return z(M, 2, 128), z(M, 2, 128), z(M, 2, 128), z(M, 2)

    def n(sigma, *shape):
        return sigma * torch.randn(shape, generator=gen, device=device)

    rd = p.sigma_read_mv * 1e-3
    cb = p.sigma_cblp_mv * 1e-3
    if kind == "dp":
        return n(rd, M, 2, 128), n(cb, M, 2, 2)
    cm = p.sigma_cmp_off_mv * 1e-3
    return n(cm, M, 2, 128), n(rd, M, 2, 128), n(rd, M, 2, 128), n(cb, M, 2)


def _batch_noise(gen, p: DimaParams, B, Mp, kind, device):
    """Per-query noise stacks (B, Mp, …): query ``j`` from
    ``fold_in(gen, j)``."""
    if gen is None:
        return tuple(torch.zeros((B,) + a.shape, device=device)
                     for a in _expand_noise(None, p, Mp, kind, device))
    per = [_expand_noise(g, p, Mp, kind, device)
           for g in noise_mod.split(gen, B)]
    return tuple(torch.stack(arrs) for arrs in zip(*per))


def _stack_bank_noise(gen, p: DimaParams, NB, Mp, kind, device, B=None,
                      offset=0):
    """Per-bank noise stacks (NB, …): bank ``b`` from ``fold_in(gen,
    offset + b)`` in the matvec (``B=None``) or matmat layout."""
    def one(g):
        if B is None:
            return _expand_noise(g, p, Mp, kind, device)
        return _batch_noise(g, p, B, Mp, kind, device)

    if gen is None:
        return tuple(torch.zeros((NB,) + a.shape, device=device)
                     for a in one(None))
    per = [one(noise_mod.fold_in(gen, offset + b)) for b in range(NB)]
    return tuple(torch.stack(arrs) for arrs in zip(*per))


def _chip_arrays(chip, p: DimaParams, device):
    if chip is None:
        n = p.words_per_access
        return (torch.ones((n,), device=device),
                torch.zeros((n,), device=device),
                torch.ones((2, n), device=device),
                torch.zeros((2, n), device=device))
    return tuple(chip[k].to(device=device, dtype=torch.float32).contiguous()
                 for k in noise_mod.CHIP_KEYS)


def _trim_ep(trim, qs):
    """Pack the fused-epilogue kernel operand from a trim coefficient
    triple and the (possibly padded) query batch: (B, 4) f32 rows
    ``[c0, c1, c2, Σq_b]``.  The query sum is exact in float32 (≤
    256·255 < 2²⁴) and zero padding cannot change it."""
    if trim is None:
        return None
    qsum = qs.to(torch.float32).sum(-1)                        # (B,)
    c = torch.as_tensor(trim, dtype=torch.float32).to(qs.device).reshape(3)
    return torch.cat([c.expand(qsum.shape[0], 3), qsum[:, None]], dim=1)


def _default_range(mode, p: DimaParams):
    return ((0.0, 255.0 * 255.0 * dp_gain(p)) if mode == "dp"
            else (0.0, 255.0 * md_gain(p)))


def _words(x, device=None):
    t = torch.as_tensor(x)
    return t.to(device=device or t.device, dtype=torch.uint8).contiguous()


def _single(d, qs, p, chip, gen, v_range, trim, mode, batched):
    """One bank of rows (M, 256) against one query or a batch: pad M to
    128, expand the noise, one query-batched kernel launch, trim the
    padding."""
    d = _words(d)
    dev = d.device
    qs = _words(qs, dev)
    qs2 = qs if batched else qs.reshape(1, -1)
    M = d.shape[0]
    dp_ = _pad_to(d, 128, 0)
    Mp = dp_.shape[0]
    cg, ce, mg, mo = _chip_arrays(chip, p, dev)
    if batched:
        noise = _batch_noise(gen, p, qs2.shape[0], Mp, mode, dev)
    else:
        noise = tuple(a[None] for a in _expand_noise(gen, p, Mp, mode, dev))
    vr = adc_mod.window(_default_range(mode, p) if v_range is None
                        else v_range, dev).reshape(1, 2)
    ep = _trim_ep(trim, qs2)
    if mode == "dp":
        out = _dp_batch(dp_, qs2, cg, ce, mg, mo, *noise, vr, ep, params=p)
    else:
        out = _md_batch(dp_, qs2, cg, ce, *noise, vr, ep, params=p)
    if batched:
        return tuple(o[:, :M] for o in out)
    return tuple(o[0, :M] for o in out)


def dima_dp_banked(d, q, p: DimaParams = DimaParams(), chip=None, gen=None,
                   v_range=None, trim=None):
    """Banked DP: d (M, 256) uint8 rows vs one query q (256,).  Returns
    (codes (M,), volts (M,)), M padded internally to 128; with
    ``trim=(c0, c1, c2)`` the fused epilogue appends trimmed scores."""
    return _single(d, q, p, chip, gen, v_range, trim, "dp", False)


def dima_md_banked(d, q, p: DimaParams = DimaParams(), chip=None, gen=None,
                   v_range=None, trim=None):
    """Banked MD: d (M, 256) rows vs one query.  Returns (codes, volts);
    ``trim`` appends fused trimmed scores."""
    return _single(d, q, p, chip, gen, v_range, trim, "md", False)


def dima_dp_matmat(d, qs, p: DimaParams = DimaParams(), chip=None, gen=None,
                   v_range=None, trim=None):
    """Query-batched DP: d (M, 256) uint8 rows vs queries qs (B, 256).
    Returns (codes (B, M), volts (B, M)) from ONE kernel launch; ``trim``
    appends fused trimmed scores (B, M)."""
    return _single(d, qs, p, chip, gen, v_range, trim, "dp", True)


def dima_md_matmat(d, qs, p: DimaParams = DimaParams(), chip=None, gen=None,
                   v_range=None, trim=None):
    """Query-batched MD: d (M, 256) rows vs queries qs (B, 256) in one
    kernel launch; ``trim`` appends fused trimmed scores."""
    return _single(d, qs, p, chip, gen, v_range, trim, "md", True)


# ---------------------------------------------------------------------------
# bank-fused wrappers: the multibank backend's banks as ONE launch
# ---------------------------------------------------------------------------

def _bank_fused(d, q_or_qs, p, chip, gen, v_range, mode, matvec, trim=None,
                bank_offset=0):
    """Pad each bank's rows to the 128-row block, build the per-bank
    noise stacks, launch the bank-leading kernel once, trim the padding.
    ``v_range`` may be a shared (lo, hi) window or a per-bank (NB, 2)
    array."""
    d = _words(d)
    dev = d.device
    NB, M = d.shape[0], d.shape[1]
    dp_ = _pad_to(d, 128, 1)
    Mp = dp_.shape[1]
    cg, ce, mg, mo = _chip_arrays(chip, p, dev)
    vr = adc_mod.window(_default_range(mode, p) if v_range is None
                        else v_range, dev).reshape(-1, 2)
    if vr.shape[0] != NB:                  # shared window -> one row/bank
        vr = vr.expand(NB, 2)
    vr = vr.contiguous()
    qs = _words(q_or_qs, dev)
    qs2 = qs.reshape(1, -1) if matvec else qs
    ep = _trim_ep(trim, qs2)
    if matvec:
        noise = tuple(a[:, None] for a in _stack_bank_noise(
            gen, p, NB, Mp, mode, dev, offset=bank_offset))
    else:
        noise = _stack_bank_noise(gen, p, NB, Mp, mode, dev,
                                  B=qs2.shape[0], offset=bank_offset)
    if mode == "dp":
        out = _dp_bank(dp_, qs2, cg, ce, mg, mo, *noise, vr, ep, params=p)
    else:
        out = _md_bank(dp_, qs2, cg, ce, *noise, vr, ep, params=p)
    if matvec:
        return tuple(o[:, 0, :M] for o in out)       # (NB, M)
    return tuple(o[:, :, :M] for o in out)           # (NB, B, M)


def dima_dp_bank_matvec(d, q, p: DimaParams = DimaParams(), chip=None,
                        gen=None, v_range=None, trim=None, bank_offset=0):
    """Banked fused DP matvec: d (NB, M, 256) uint8 — stacked banks — vs
    one query q (256,).  Bank ``b`` draws noise from ``fold_in(gen,
    bank_offset + b)`` with the ``dima_dp_banked`` layout.  Returns
    (codes (NB, M), volts (NB, M)) from ONE launch; ``trim`` appends
    fused trimmed scores (NB, M)."""
    return _bank_fused(d, q, p, chip, gen, v_range, "dp", True, trim,
                       bank_offset)


def dima_md_bank_matvec(d, q, p: DimaParams = DimaParams(), chip=None,
                        gen=None, v_range=None, trim=None, bank_offset=0):
    """Banked fused MD matvec (see ``dima_dp_bank_matvec``)."""
    return _bank_fused(d, q, p, chip, gen, v_range, "md", True, trim,
                       bank_offset)


def dima_dp_bank_matmat(d, qs, p: DimaParams = DimaParams(), chip=None,
                        gen=None, v_range=None, trim=None, bank_offset=0):
    """Banked fused DP matmat: d (NB, M, 256) vs queries qs (B, 256);
    bank ``b`` uses the ``dima_dp_matmat`` noise layout under
    ``fold_in(gen, bank_offset + b)``.  Returns (codes (NB, B, M), volts)
    from ONE launch; ``trim`` appends fused trimmed scores."""
    return _bank_fused(d, qs, p, chip, gen, v_range, "dp", False, trim,
                       bank_offset)


def dima_md_bank_matmat(d, qs, p: DimaParams = DimaParams(), chip=None,
                        gen=None, v_range=None, trim=None, bank_offset=0):
    """Banked fused MD matmat (see ``dima_dp_bank_matmat``)."""
    return _bank_fused(d, qs, p, chip, gen, v_range, "md", False, trim,
                       bank_offset)
