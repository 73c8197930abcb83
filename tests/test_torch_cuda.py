"""The port on the card: each CUDA kernel against its plain version on the
same explicit noise, the kernel backend against the reference backend,
and the launch counters.  Marked ``cuda``; each test asks for the card
through the ``card`` fixture and skips where none is visible.  On a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance (``repro_torch.parity``): codes equal except within 1e-7 V of
an ADC boundary, volts to 1e-7 V, trimmed to 1e-6 of the score scale.
"""
import numpy as np
import pytest
import torch

from repro_torch import parity
from repro_torch.core import api, noise
from repro_torch.core import pipeline as pl
from repro_torch.core.params import DimaParams
from repro_torch.kernels import dima_dp, dima_md, ops

pytestmark = pytest.mark.cuda

P = DimaParams()
TRIM = (0.98, -0.5, 3.0)
# terms near 1e7 that cancel to a score near 0, as a calibrated trim's do:
# an ulp of any intermediate (a reciprocal for a quotient) shows here
TRIMS = {"off": None, "on": TRIM, "cancel": (1.0, -127.5, 0.0)}
KERNELS = {"dima_dp_batch": dima_dp, "dima_dp_bank_batch": dima_dp,
           "dima_md_batch": dima_md, "dima_md_bank_batch": dima_md}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is visible")
    return torch.device("cuda")


def _operands(mode, nb, b, m, trim, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    chip = noise.sample_chip(torch.Generator().manual_seed(7), P, dev)
    d = torch.randint(0, 256, (nb, m, 256), dtype=torch.uint8, generator=g,
                      device=dev)
    qs = torch.randint(0, 256, (b, 256), dtype=torch.uint8, generator=g,
                       device=dev)
    cg, ce, mg, mo = ops._chip_arrays(chip, P, dev)

    def n(sigma, *shape):
        return sigma * 1e-3 * torch.randn(shape, generator=g, device=dev)

    if mode == "dp":
        rest = (mg, mo, n(P.sigma_read_mv, nb, b, m, 2, 128),
                n(P.sigma_cblp_mv, nb, b, m, 2, 2))
        hi = 255.0 * 255.0 * pl.dp_gain(P)
    else:
        rest = (n(P.sigma_cmp_off_mv, nb, b, m, 2, 128),
                n(P.sigma_read_mv, nb, b, m, 2, 128),
                n(P.sigma_read_mv, nb, b, m, 2, 128),
                n(P.sigma_cblp_mv, nb, b, m, 2))
        hi = 255.0 * pl.md_gain(P)
    vr = torch.tensor([[0.0, hi * (0.6 + 0.1 * k)] for k in range(nb)],
                      device=dev)
    return (d, qs, cg, ce, *rest), vr, ops._trim_ep(trim, qs)


@pytest.mark.parametrize("trim", sorted(TRIMS))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_plain_version(card, name, trim):
    mode = name.split("_")[1]
    bank = "bank" in name
    nb, b, m = (3, 5, 100) if bank else (1, 7, 300)
    ops_, vr, ep = _operands(mode, nb, b, m, TRIMS[trim], card)
    mod = KERNELS[name]
    before = mod.launches[name]
    if bank:
        got = getattr(mod, name)(*ops_, vr, ep, params=P)
    else:
        d, qs, *rest = ops_
        got = getattr(mod, name)(d[0], qs, *[t[0] if t.dim() >= 4 else t
                                             for t in rest], vr, ep,
                                 params=P)
        got = tuple(o[None] for o in got)
    torch.cuda.synchronize()
    assert mod.launches[name] == before + 1
    want = mod.plain(*ops_, vr, ep, P)
    parity.check_outputs(want, got, vr.reshape(nb, 1, 2), label=name)
    if ep is not None:          # trimmed is a function of the code alone
        same = want[0] == got[0]
        assert torch.equal(want[2][same], got[2][same]), name


@pytest.mark.parametrize("mode", ["dp", "md"])
def test_kernel_backend_matches_reference_on_card(card, mode):
    rng = np.random.default_rng(1)
    D = rng.integers(0, 256, (200, 256)).astype(np.uint8)
    QS = rng.integers(0, 256, (3, 256)).astype(np.uint8)
    chip = noise.sample_chip(torch.Generator().manual_seed(7), P, card)
    ref = api.get_backend("reference", P, chip, device=card)
    for be in (api.get_backend("kernel", P, chip, device=card),
               api.get_backend("multibank", P, chip, device=card,
                               inner="kernel", n_banks=32)):
        for op, q in (("matvec", QS[0]), ("matmat", QS)):
            a = getattr(ref, op)(D, q, mode=mode, trim=TRIM)
            b = getattr(be, op)(D, q, mode=mode, trim=TRIM)
            assert b.code.is_cuda
            parity.check_outputs((a.code, a.volts, a.trimmed),
                                 (b.code, b.volts, b.trimmed),
                                 ops._default_range(mode, P),
                                 label=f"{be.name}/{op}")


def test_flagship_is_one_launch(card):
    rng = np.random.default_rng(3)
    D = rng.integers(0, 256, (4096, 256)).astype(np.uint8)
    Q = rng.integers(0, 256, (256,)).astype(np.uint8)
    mb = api.get_backend("multibank", P, None, device=card, inner="kernel",
                         n_banks=32)
    before = dict(dima_dp.launches)
    out = mb.matvec(D, Q, gen=torch.Generator(device=card).manual_seed(1),
                    trim=TRIM)
    torch.cuda.synchronize()
    assert dima_dp.launches["dima_dp_bank_batch"] == \
        before["dima_dp_bank_batch"] + 1
    assert dima_dp.launches["dima_dp_batch"] == before["dima_dp_batch"]
    assert out.code.shape == (4096,) and torch.isfinite(out.trimmed).all()


def test_wrappers_reject_misaligned_operands(card):
    (d, qs, cg, ce, mg, mo, rn, cn), vr, _ = _operands("dp", 1, 2, 64,
                                                       None, card)
    flat = torch.empty(rn.numel() + 1, device=card)
    shifted = flat[1:].view(rn.shape[1:])            # 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        dima_dp.dima_dp_batch(d[0], qs, cg, ce, mg, mo, shifted, cn[0], vr)
