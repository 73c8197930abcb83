"""Static mismatch (per chip instance) and dynamic noise sampling.

Static mismatch is sampled once per simulated chip (`sample_chip`) and
reused across reads — matching silicon, where column gain / cap-ratio /
multiplier errors are fixed-pattern.  Dynamic noise (thermal, PWM jitter,
comparator) is drawn per read from the call's ``torch.Generator``.

Generators stand where the JAX package has keys.  Two rules replace
``jax.random.split``/``fold_in``:

* a function that draws noise draws it straight from the generator it is
  given, in the order its docstring states (the generator advances, as
  any PyTorch generator does);
* ``fold_in(gen, i)`` derives child ``i`` from the generator's *current
  state* without advancing it — a fresh generator on the same device
  seeded with a hash of (state, i) — and ``split(gen, n)`` is children
  0..n-1.  So, as with a JAX key, the same parent state always gives the
  same children: this is how a query batch, a bank stack and the
  conversion chunks of one op each get their own reproducible stream.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.core.params import DimaParams
from repro_torch.device import resolve_device

CHIP_KEYS = ("col_gain", "cap_ratio_err", "mult_gain", "mult_off")


def fold_in(gen: torch.Generator, i: int) -> torch.Generator:
    """Child generator ``i`` of ``gen`` (``gen`` itself does not advance)."""
    state = gen.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(i).to_bytes(8, "little"),
                             digest_size=8).digest()
    child = torch.Generator(device=gen.device)
    child.manual_seed(int.from_bytes(digest, "little") & (2 ** 63 - 1))
    return child


def split(gen: torch.Generator, n: int):
    """Children 0..n-1 of ``gen`` (see ``fold_in``)."""
    return [fold_in(gen, i) for i in range(n)]


def sample_chip(gen: torch.Generator, p: DimaParams = DimaParams(),
                device=None):
    """Fixed-pattern mismatch for one chip instance: four standard-normal
    draws from ``gen`` in the order of the record's keys, made on the
    generator's device and moved to ``device`` (so a CPU generator gives
    the same chip on either device)."""
    dev = resolve_device(device)
    n = p.words_per_access

    def z(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    chip = {
        "col_gain": 1.0 + p.sigma_gain_col * z(n),
        "cap_ratio_err": p.sigma_cap_ratio * z(n),
        "mult_gain": 1.0 + p.sigma_mult_gain * z(2, n),
        "mult_off": p.sigma_mult_off_mv * 1e-3 * z(2, n),
    }
    return {k: v.to(dev) for k, v in chip.items()}


def ideal_chip(p: DimaParams = DimaParams(), device=None):
    dev = resolve_device(device)
    n = p.words_per_access
    return {
        "col_gain": torch.ones((n,), device=dev),
        "cap_ratio_err": torch.zeros((n,), device=dev),
        "mult_gain": torch.ones((2, n), device=dev),
        "mult_off": torch.zeros((2, n), device=dev),
    }


def normal(gen, shape, sigma, device):
    """``sigma``·N(0, 1) of ``shape`` drawn from ``gen`` on ``device``;
    zeros when ``gen`` is None or ``sigma`` is 0."""
    if gen is None or sigma == 0.0:
        return torch.zeros(shape, device=device)
    return sigma * torch.randn(shape, generator=gen, device=device)
