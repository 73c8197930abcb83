"""Unified ``DimaBackend`` compute API — the counterpart of
``repro.core.api``: one signature over the digital, reference and kernel
paths.

Every backend exposes ``dot`` / ``manhattan`` / ``matvec`` / ``matmat``
with the single signature ``(stored, query, *, mode, gen, v_range, trim)
-> DimaOut``, plus ``decode`` and a ``decision_cost`` energy/timing
model, so applications never care which substrate runs the op.  A
backend owns its ``device`` (CUDA unless ``device="cpu"``); inputs —
numpy arrays or tensors — are moved there.

Backends (``get_backend(name)``):

- ``digital``   — exact 8-b arithmetic (the conventional architecture);
                  ``volts`` is the ideal linear transfer.
- ``reference`` — the plain PyTorch behavioral model (core/pipeline.py),
                  one broadcast pass per op.
- ``kernel``    — the DIMA kernels (kernels/ops.py): the CUDA kernels on
                  the card, their plain versions on the CPU; the chip
                  record → explicit-noise expansion happens inside.  The
                  counterpart of the JAX package's ``pallas`` backend.
- ``multibank`` — the paper's multi-bank scenario executed: rows sharded
                  over ``n_banks`` banks and run as ONE fused op — one
                  bank-leading kernel launch (kernel inner) or one
                  broadcast pipeline pass (reference inner) — with the
                  per-bank ADC codes merged digitally; costs amortize the
                  fixed CTRL energy.

``auto``, ``bitserial``, the robust multibank path (variation, faults,
redundancy) and the mesh fan-out are still to be ported.

Noise: ``gen`` is a ``torch.Generator`` on the backend's device, or None
for zero noise.  Per-query and per-bank streams follow the rule in
``kernels/ops.py``; with ``gen=None`` every backend agrees with the JAX
backend of the same name (``kernel`` with ``pallas``).

Ops on >256-dim vectors go through :func:`chunked_dot` — one ADC
conversion per 256-dim segment, decoded codes summed digitally.
"""
from __future__ import annotations

import difflib

import torch
import torch.nn.functional as F

from repro_torch.core import adc as adc_mod
from repro_torch.core import energy as energy_mod
from repro_torch.core import noise as noise_mod
from repro_torch.core import pipeline as pl
from repro_torch.core.params import DimaParams
from repro_torch.core.pipeline import DimaOut
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

MODES = ("dp", "md")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _check_op_dims(n: int, p: DimaParams) -> None:
    """One op = one ADC conversion (two charge-shared access cycles)."""
    if n > p.dims_per_conversion:
        raise ValueError(
            f"one op is one ≤{p.dims_per_conversion}-dim conversion "
            f"(got n={n}); split long vectors with chunked_dot")


def _trim_eager(code, query, coef, p, v_range, mode, per_query=False):
    """The calibration epilogue over emitted codes, for paths with no
    launch of their own to fuse it into (digital, the reference
    pipeline).  ``per_query`` reshapes Σq to (b, 1) for (b, m) codes."""
    q_sum = query.to(torch.float32).sum(-1)
    if per_query:
        q_sum = q_sum[:, None]
    return pl.trim_epilogue(code, q_sum, coef, p, v_range, mode)


class DimaBackend:
    """Base class for one compute substrate.

    A backend owns the circuit parameters ``p``, one silicon instance
    ``chip`` (fixed-pattern mismatch record, or None = ideal) and its
    ``device``; per-call state is the data, the noise generator ``gen``
    and the programmed ADC ``v_range``.  ``DimaOut.n_cycles`` /
    ``n_conversions`` are per-op for ``dot`` / ``manhattan`` and totals
    for ``matvec`` / ``matmat``.
    """

    name = "abstract"
    executes_multibank = False

    def __init__(self, p: DimaParams = None, chip=None, device=None):
        self.p = p if p is not None else DimaParams()
        self.device = resolve_device(device)
        self.chip = (None if chip is None else
                     {k: torch.as_tensor(chip[k], dtype=torch.float32)
                      .to(self.device) for k in noise_mod.CHIP_KEYS})

    def ideal(self) -> "DimaBackend":
        """The same substrate with an ideal chip — what range calibration
        runs on."""
        return type(self)(self.p, None, self.device)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    # ``trim=(c0, c1, c2)`` on any op switches on the fused calibration
    # epilogue: the op also returns ``DimaOut.trimmed``, the affine-trimmed
    # score ``c0·d̂ + c1·Σq + c2`` (pipeline.trim_epilogue), computed in
    # the op's own kernel launch where the substrate has one.

    def dot(self, stored, query, *, mode="dp", gen=None,
            v_range=None, trim=None) -> DimaOut:
        """One ≤256-dim op per trailing dim; leading dims broadcast."""
        raise NotImplementedError

    def manhattan(self, stored, query, *, mode="md", gen=None,
                  v_range=None, trim=None) -> DimaOut:
        return self.dot(stored, query, mode=mode, gen=gen, v_range=v_range,
                        trim=trim)

    def matvec(self, stored, query, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        """All stored rows (m, n≤256) against one query (n,)."""
        raise NotImplementedError

    def matmat(self, stored, queries, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        """stored (m, n) × queries (b, n) -> codes (b, m); query ``j``
        draws from ``noise.fold_in(gen, j)``."""
        queries = self._t(queries)
        b = queries.shape[0]
        gens = noise_mod.split(gen, b) if gen is not None else [None] * b
        outs = [self.matvec(stored, queries[j], mode=mode, gen=gens[j],
                            v_range=v_range, trim=trim) for j in range(b)]
        trimmed = (None if trim is None
                   else torch.stack([o.trimmed for o in outs]))
        return DimaOut(torch.stack([o.code for o in outs]),
                       torch.stack([o.volts for o in outs]),
                       sum(o.n_cycles for o in outs),
                       sum(o.n_conversions for o in outs), trimmed)

    def decode(self, code, *, mode="dp", v_range=None):
        """ADC code -> operation units (dot value or Manhattan distance)."""
        _check_mode(mode)
        f = pl.code_to_dot if mode == "dp" else pl.code_to_md
        return f(code, self.p, v_range)

    def decision_cost(self, n_dims: int, *, mode="dp", n_ops=1,
                      multi_bank=False, **kw) -> energy_mod.Cost:
        """Modeled energy/timing of one decision on this substrate."""
        return energy_mod.dima_decision(self.p, n_dims, mode=mode,
                                        n_ops=n_ops, multi_bank=multi_bank,
                                        **kw)


# ---------------------------------------------------------------------------
# registry / factory
# ---------------------------------------------------------------------------

BACKENDS: dict = {}


def register_backend(name: str):
    """Class decorator: make a backend constructible via get_backend."""
    def deco(cls):
        cls.name = name
        BACKENDS[name] = cls
        return cls
    return deco


def get_backend(name: str = "kernel", p: DimaParams = None, chip=None,
                **kwargs) -> DimaBackend:
    """Factory: ``get_backend("digital" | "reference" | "kernel" |
    "multibank", p, chip, device=..., ...)``.  Returns an
    already-constructed backend unchanged; raises ``KeyError`` listing
    the registered names on a typo."""
    if not isinstance(name, str):
        return name
    if name not in BACKENDS:
        close = difflib.get_close_matches(str(name), BACKENDS, n=1)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise KeyError(f"unknown backend {name!r}; registered backends: "
                       f"{sorted(BACKENDS)}{hint}")
    return BACKENDS[name](p, chip, **kwargs)


# ---------------------------------------------------------------------------
# digital: exact 8-b arithmetic (the conventional architecture)
# ---------------------------------------------------------------------------

@register_backend("digital")
class DigitalBackend(DimaBackend):
    """Bit-exact integer compute.  ``volts`` is the *ideal* linear analog
    transfer of the exact result, so codes/volts compare directly with
    the analog backends; ``gen`` is accepted and ignored."""

    def _gain(self, mode):
        return pl.dp_gain(self.p) if mode == "dp" else pl.md_gain(self.p)

    def _default_range(self, mode):
        full = 255.0 * 255.0 if mode == "dp" else 255.0
        return (0.0, full * self._gain(mode))

    def dot(self, stored, query, *, mode="dp", gen=None,
            v_range=None, trim=None) -> DimaOut:
        _check_mode(mode)
        stored, query = self._t(stored), self._t(query)
        n = max(stored.shape[-1], query.shape[-1])
        _check_op_dims(n, self.p)
        exact_f = pl.digital_dot if mode == "dp" else pl.digital_manhattan
        exact = exact_f(stored, query)
        v = exact.to(torch.float32) / self.p.dims_per_conversion \
            * self._gain(mode)
        if v_range is None:
            v_range = self._default_range(mode)
        code = adc_mod.adc(v, v_range[0], v_range[1], self.p)
        trimmed = (None if trim is None
                   else _trim_eager(code, query, trim, self.p, v_range, mode))
        return DimaOut(code, v, pl._cycles_per_op(n, self.p), 1, trimmed)

    def matvec(self, stored, query, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        stored = self._t(stored)
        m = stored.shape[0]
        out = self.dot(stored, query, mode=mode, v_range=v_range, trim=trim)
        return DimaOut(out.code, out.volts, m * out.n_cycles, m, out.trimmed)

    def decision_cost(self, n_dims: int, *, mode="dp", n_ops=1,
                      multi_bank=False, **kw) -> energy_mod.Cost:
        # the conventional fetch-then-compute architecture (no banks)
        return energy_mod.conventional_decision(self.p, n_dims, mode=mode,
                                                n_ops=n_ops)


# ---------------------------------------------------------------------------
# reference: the plain PyTorch behavioral model
# ---------------------------------------------------------------------------

@register_backend("reference")
class ReferenceBackend(DimaBackend):
    """core/pipeline.py behind the unified signature; noise is drawn from
    ``gen`` in the pipeline's order at the op's full broadcast shape."""

    def _run(self, kind, stored, query, mode, gen, v_range, trim):
        _check_mode(mode)
        p, chip = self.p, self.chip
        if kind == "op":
            f = pl.dima_dot if mode == "dp" else pl.dima_manhattan
            code, volts = f(stored, query, p, chip, gen, v_range)[:2]
        elif kind == "matmat":
            code, volts = pl.dima_matmat(stored, query, p, chip, gen, mode,
                                         v_range)
        else:
            code, volts = pl.dima_matvec(stored, query, p, chip, gen, mode,
                                         v_range)[:2]
        trimmed = (None if trim is None else
                   _trim_eager(code, query, trim, p, v_range, mode,
                               per_query=(kind == "matmat")))
        return code, volts, trimmed

    def dot(self, stored, query, *, mode="dp", gen=None,
            v_range=None, trim=None) -> DimaOut:
        stored, query = self._t(stored), self._t(query)
        n = max(stored.shape[-1], query.shape[-1])
        _check_op_dims(n, self.p)
        code, volts, trimmed = self._run("op", stored, query, mode, gen,
                                         v_range, trim)
        return DimaOut(code, volts, pl._cycles_per_op(n, self.p), 1, trimmed)

    def matvec(self, stored, query, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        stored = self._t(stored)
        m = stored.shape[0]
        _check_op_dims(stored.shape[-1], self.p)
        code, volts, trimmed = self._run("matvec", stored, self._t(query),
                                         mode, gen, v_range, trim)
        return DimaOut(code, volts,
                       m * pl._cycles_per_op(stored.shape[-1], self.p), m,
                       trimmed)

    def matmat(self, stored, queries, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        stored, queries = self._t(stored), self._t(queries)
        b, m = queries.shape[0], stored.shape[0]
        _check_op_dims(stored.shape[-1], self.p)
        code, volts, trimmed = self._run("matmat", stored, queries, mode,
                                         gen, v_range, trim)
        return DimaOut(code, volts,
                       b * m * pl._cycles_per_op(stored.shape[-1], self.p),
                       b * m, trimmed)


# ---------------------------------------------------------------------------
# kernel: the DIMA kernels (CUDA on the card, plain versions on the CPU)
# ---------------------------------------------------------------------------

@register_backend("kernel")
class KernelBackend(DimaBackend):
    """kernels/ops.py behind the unified signature — the counterpart of
    the JAX package's ``pallas`` backend.  It pads the trailing dim to
    one conversion and expands the chip record and ``gen`` into the
    kernels' explicit noise operands.  On the card every op is a CUDA
    kernel launch; nothing routes around the kernels.

    Noise caveat: per-read noise is drawn with the ops' layout, so noisy
    results are statistically — not bitwise — equivalent to the
    reference backend; with ``gen=None`` they agree."""

    KERNEL_MODES = ("dp", "md")

    def _require_kernel_mode(self, mode):
        _check_mode(mode)
        if mode not in self.KERNEL_MODES:
            raise ValueError(
                f"the DIMA kernels implement modes {self.KERNEL_MODES}, "
                f"not {mode!r} — use get_backend('reference') for this op")

    def _banked(self, stored, query, mode, gen, v_range, trim=None):
        self._require_kernel_mode(mode)
        _check_op_dims(stored.shape[-1], self.p)
        d = pl._pad_to_conversion(stored.to(torch.int32), self.p)
        q = pl._pad_to_conversion(query.to(torch.int32), self.p)
        f = kops.dima_dp_banked if mode == "dp" else kops.dima_md_banked
        return f(d, q, self.p, self.chip, gen, v_range, trim=trim)

    def dot(self, stored, query, *, mode="dp", gen=None,
            v_range=None, trim=None) -> DimaOut:
        """Decomposes onto the kernels.  Besides (n,)/(m, n) × (n,), the
        two broadcast layouts the applications/calibration use run as one
        matmat launch: one stored row × a query batch ((1, n) × (B, n) ->
        (B,)) and a stored bank × a query batch ((1, m, n) × (b, 1, n) ->
        (b, m))."""
        self._require_kernel_mode(mode)
        stored, query = self._t(stored), self._t(query)
        per_op = pl._cycles_per_op(stored.shape[-1], self.p)

        def _sl(t, idx):
            return None if t is None else t[idx]

        kw = dict(mode=mode, gen=gen, v_range=v_range, trim=trim)
        if stored.dim() == 1 and query.dim() == 1:
            out = self.matvec(stored[None, :], query, **kw)
            return DimaOut(out.code[0], out.volts[0], per_op, 1,
                           _sl(out.trimmed, 0))
        if stored.dim() == 2 and query.dim() == 1:
            out = self.matvec(stored, query, **kw)
            return DimaOut(out.code, out.volts, per_op, 1, out.trimmed)
        if stored.dim() == 2 and stored.shape[0] == 1 and query.dim() == 2:
            out = self.matmat(stored, query, **kw)
            return DimaOut(out.code[:, 0], out.volts[:, 0], per_op, 1,
                           _sl(out.trimmed, (slice(None), 0)))
        if (stored.dim() == 3 and stored.shape[0] == 1 and query.dim() == 3
                and query.shape[1] == 1):
            out = self.matmat(stored[0], query[:, 0, :], **kw)
            return DimaOut(out.code, out.volts, per_op, 1, out.trimmed)
        raise ValueError(
            f"kernel backend supports stored (n,)/(m, n) × query (n,), "
            f"(1, n) × (B, n), or (1, m, n) × (b, 1, n); got "
            f"{tuple(stored.shape)} × {tuple(query.shape)} — use the "
            "reference backend for general broadcasts")

    def matvec(self, stored, query, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        stored = self._t(stored)
        if stored.dim() != 2:
            raise ValueError(f"matvec wants stored (m, n); got "
                             f"{tuple(stored.shape)}")
        m = stored.shape[0]
        out = self._banked(stored, self._t(query), mode, gen, v_range, trim)
        return DimaOut(out[0], out[1],
                       m * pl._cycles_per_op(stored.shape[-1], self.p), m,
                       out[2] if len(out) == 3 else None)

    def matmat(self, stored, queries, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        """ONE kernel launch for the whole (b, m) code matrix; query ``j``
        draws from ``noise.fold_in(gen, j)``."""
        self._require_kernel_mode(mode)
        stored, queries = self._t(stored), self._t(queries)
        if stored.dim() != 2 or queries.dim() != 2:
            raise ValueError(f"matmat wants stored (m, n) × queries (b, n); "
                             f"got {tuple(stored.shape)} × "
                             f"{tuple(queries.shape)}")
        _check_op_dims(stored.shape[-1], self.p)
        b, m = queries.shape[0], stored.shape[0]
        d = pl._pad_to_conversion(stored.to(torch.int32), self.p)
        q = pl._pad_to_conversion(queries.to(torch.int32), self.p)
        f = kops.dima_dp_matmat if mode == "dp" else kops.dima_md_matmat
        out = f(d, q, self.p, self.chip, gen, v_range, trim=trim)
        return DimaOut(out[0], out[1],
                       b * m * pl._cycles_per_op(stored.shape[-1], self.p),
                       b * m, out[2] if len(out) == 3 else None)


# ---------------------------------------------------------------------------
# multibank: the paper's multi-bank scenario, executed
# ---------------------------------------------------------------------------

@register_backend("multibank")
class MultiBankBackend(DimaBackend):
    """Bank-sharded execution: ``stored`` rows are split into ``n_banks``
    contiguous banks (last bank ragged when the row count does not
    divide, trailing banks empty when m < n_banks), one ``matvec`` /
    ``matmat`` runs every bank at once, and the per-bank ADC codes are
    merged digitally — a concatenation in row order; ``decision_cost``
    amortizes the fixed CTRL energy over the banks.

    The ragged last bank is zero-padded to the full banks' row count and
    rides the same stack, so every op is ONE fused computation: with the
    ``kernel`` inner (the default), one bank-leading kernel launch
    (``kernels/ops.py *_bank_*``; bank ``b`` draws noise from
    ``noise.fold_in(gen, b)``); with ``inner="reference"``, one
    broadcast pass of the pipeline over (bank, [query], row).

    Still to be ported, and refused here with ``NotImplementedError``:
    fleet variation/drift, fault injection, redundancy voting and the
    device-mesh fan-out.
    """

    executes_multibank = True

    def __init__(self, p: DimaParams = None, chip=None, device=None,
                 inner="kernel", n_banks: int = None, mesh=None,
                 variation=None, faults=None, redundancy: int = 1):
        if (mesh is not None or variation is not None or faults
                or int(redundancy) != 1):
            raise NotImplementedError(
                "the port's multibank backend runs the fused path only; "
                "variation, faults, redundancy > 1 and mesh fan-out are "
                "still to be ported")
        super().__init__(p, chip, device)
        self.n_banks = (self.p.n_banks_multibank if n_banks is None
                        else int(n_banks))
        if self.n_banks < 1:
            raise ValueError(f"n_banks must be >= 1; got {self.n_banks}")
        self.inner = (inner if isinstance(inner, DimaBackend)
                      else get_backend(inner, self.p, chip,
                                       device=self.device))
        if self.inner.executes_multibank:
            raise ValueError("inner backend must be a single-bank substrate")
        if not isinstance(self.inner, (ReferenceBackend, KernelBackend)):
            raise NotImplementedError(
                f"inner={self.inner.name!r}: the fused path exists for the "
                "reference and kernel inners; the per-bank loop is still "
                "to be ported")

    def ideal(self) -> "MultiBankBackend":
        return MultiBankBackend(self.p, None, self.device,
                                inner=self.inner.ideal(),
                                n_banks=self.n_banks)

    def bank_slices(self, m: int):
        """Contiguous (start, stop) row blocks, one per occupied bank."""
        rows_per = -(-m // self.n_banks)             # ceil
        return [(a, min(a + rows_per, m)) for a in range(0, m, rows_per)]

    def _stack(self, stored):
        """(m, n) rows -> (occupied banks, rows_per, n), the ragged last
        bank zero-padded to rows_per."""
        m = stored.shape[0]
        rows_per = -(-m // self.n_banks)
        nb = -(-m // rows_per)
        stored = F.pad(stored, (0, 0, 0, nb * rows_per - m))
        return stored.reshape(nb, rows_per, stored.shape[-1])

    def dot(self, stored, query, *, mode="dp", gen=None,
            v_range=None, trim=None) -> DimaOut:
        """A single op occupies a single bank: straight delegation (the
        cost model still amortizes — the paper's † rows)."""
        return self.inner.dot(stored, query, mode=mode, gen=gen,
                              v_range=v_range, trim=trim)

    def matvec(self, stored, query, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        stored = self._t(stored)
        if stored.dim() != 2:
            raise ValueError(f"matvec wants stored (m, n); got "
                             f"{tuple(stored.shape)}")
        return self._fused("matvec", stored, self._t(query), mode, gen,
                           v_range, trim)

    def matmat(self, stored, queries, *, mode="dp", gen=None,
               v_range=None, trim=None) -> DimaOut:
        stored, queries = self._t(stored), self._t(queries)
        if stored.dim() != 2 or queries.dim() != 2:
            raise ValueError(f"matmat wants stored (m, n) × queries (b, n); "
                             f"got {tuple(stored.shape)} × "
                             f"{tuple(queries.shape)}")
        return self._fused("matmat", stored, queries, mode, gen, v_range,
                           trim)

    def _fused(self, kind, stored, q, mode, gen, v_range, trim) -> DimaOut:
        _check_mode(mode)
        m, n = stored.shape
        _check_op_dims(n, self.p)
        banks = self._stack(stored.to(torch.int32))
        if isinstance(self.inner, KernelBackend):
            self.inner._require_kernel_mode(mode)
            f = {("matvec", "dp"): kops.dima_dp_bank_matvec,
                 ("matvec", "md"): kops.dima_md_bank_matvec,
                 ("matmat", "dp"): kops.dima_dp_bank_matmat,
                 ("matmat", "md"): kops.dima_md_bank_matmat}[(kind, mode)]
            out = f(pl._pad_to_conversion(banks, self.p),
                    pl._pad_to_conversion(q.to(torch.int32), self.p),
                    self.p, self.chip, gen, v_range, trim=trim)
            code, volts = out[0], out[1]
            trimmed = out[2] if len(out) == 3 else None
        else:
            f = pl.dima_dot if mode == "dp" else pl.dima_manhattan
            if kind == "matvec":
                d_b, q_b = banks, q
            else:                       # (nb, 1, rows, n) × (1, B, 1, n)
                d_b, q_b = banks[:, None], q[None, :, None, :]
            code, volts = f(d_b, q_b, self.p, self.chip, gen, v_range)[:2]
            trimmed = (None if trim is None else
                       _trim_eager(code, q, trim, self.p, v_range, mode,
                                   per_query=(kind == "matmat")))
        if kind == "matvec":                 # (nb, rows) -> (m,)
            merge = (lambda t: t.reshape(-1)[:m])
        else:                                # (nb, B, rows) -> (B, m)
            merge = (lambda t: t.transpose(0, 1).reshape(q.shape[0], -1)
                     [:, :m])
        n_ops = m if kind == "matvec" else q.shape[0] * m
        return DimaOut(merge(code), merge(volts),
                       n_ops * pl._cycles_per_op(n, self.p), n_ops,
                       None if trimmed is None else merge(trimmed))

    @property
    def bank_fixed_pj(self) -> float:
        """Per-bank share of the fixed CTRL energy."""
        return energy_mod.bank_fixed_split(self.p, self.n_banks)

    def decision_cost(self, n_dims: int, *, mode="dp", n_ops=1,
                      multi_bank=True, **kw) -> energy_mod.Cost:
        """Always the amortized model: this substrate *executes* banked."""
        return energy_mod.dima_decision(self.p, n_dims, mode=mode,
                                        n_ops=n_ops, multi_bank=True,
                                        n_banks=self.n_banks, **kw)


# ---------------------------------------------------------------------------
# helpers shared by the applications layer
# ---------------------------------------------------------------------------

def iter_chunks(n: int, per: int):
    """(start, stop) segments of one conversion each — the single place
    conversion chunking is defined (shared with core.calibration)."""
    for a in range(0, n, per):
        yield a, min(a + per, n)


def chunked_dot(backend: DimaBackend, stored, query, *, mode="dp", gen=None,
                v_range=None):
    """>256-dim op: one ADC conversion per ``dims_per_conversion``
    segment, decoded codes summed digitally — the prototype's dataflow
    for long vectors (e.g. the SVM's 506-dim feature).  Chunk ``i``
    draws from ``noise.fold_in(gen, i)``.  Returns the decoded total.

    Each chunk is one backend op (on the kernel backend one launch), and
    the decode + digital sum run in chunk order, as the JAX package's
    chunked path sums."""
    stored = backend._t(stored)
    query = backend._t(query)
    n = max(stored.shape[-1], query.shape[-1])
    total = 0.0
    for i, (a, b) in enumerate(iter_chunks(n, backend.p.dims_per_conversion)):
        g = None if gen is None else noise_mod.fold_in(gen, i)
        out = backend.dot(stored[..., a:b], query[..., a:b], mode=mode,
                          gen=g, v_range=v_range)
        total = total + backend.decode(out.code, mode=mode, v_range=v_range)
    return total


#: The JAX package keeps a per-chunk loop beside its vectorised
#: ``chunked_dot`` as its oracle; here ``chunked_dot`` already runs one op
#: per chunk, so the two names are one function.
chunked_dot_loop = chunked_dot
