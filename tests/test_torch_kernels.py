"""The port's DIMA kernels on the CPU, held against the JAX package.

Each test makes its inputs with numpy from a seed and feeds the same
arrays — stored words, queries, the chip record and explicit noise drawn
once by JAX (``repro.kernels.ops._expand_noise`` and friends) — to the
JAX function and to its port counterpart.  The JAX Pallas kernels run in
interpret mode, as the JAX suite runs them on the CPU.  Tolerance
(``repro_torch.parity``): codes equal except at an ADC boundary, volts to
1e-7 V, trimmed to 1e-6 of the score scale.  On the CPU the port's
kernel wrappers compute the kernels' plain versions; the card-side
comparison is tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise
from repro.core import pipeline as jpl
from repro.core.params import DimaParams as JaxParams
from repro.kernels import dima_dp as jdp
from repro.kernels import dima_md as jmd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert, parity
from repro_torch.core import noise as tnoise
from repro_torch.core import pipeline as tpl
from repro_torch.core.params import DimaParams
from repro_torch.kernels import dima_dp as tdp
from repro_torch.kernels import dima_md as tmd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

P = DimaParams()
JP = JaxParams()
CPU = torch.device("cpu")
CHIP_J = jnoise.sample_chip(jax.random.PRNGKey(7), JP)
CHIP_T = convert.chip_from_jax({k: np.asarray(v) for k, v in CHIP_J.items()},
                               device="cpu")
TRIM = (0.97, -0.4, 12.5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _window(mode):
    hi = (255.0 * 255.0 * jpl.dp_gain(JP) if mode == "dp"
          else 255.0 * jpl.md_gain(JP))
    return np.asarray([[0.01 * hi, 0.9 * hi]], np.float32)


def _words(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _chip_np():
    return [np.asarray(CHIP_J[k], np.float32) for k in tnoise.CHIP_KEYS]


@pytest.mark.parametrize("mode", ["dp", "md"])
@pytest.mark.parametrize("M", [128, 100])
def test_ref_matches_jax_ref(mode, M):
    """The plain versions agree with the JAX refs on explicit noise."""
    d, q = _words(M, M, 256), _words(M + 1, 256)
    noise = [np.asarray(a) for a in
             jops._expand_noise(jax.random.PRNGKey(M), JP, M, mode)]
    vr = _window(mode)[0]
    cg, ce, mg, mo = _chip_np()
    if mode == "dp":
        a = jref.dima_dp_ref(jnp.asarray(d), jnp.asarray(q), JP, cg, ce, mg,
                             mo, *noise, vr)
        b = tref.dima_dp_ref(_t(d), _t(q), P, _t(cg), _t(ce), _t(mg),
                             _t(mo), *map(_t, noise), _t(vr))
    else:
        a = jref.dima_md_ref(jnp.asarray(d), jnp.asarray(q), JP, cg, ce,
                             *noise, vr)
        b = tref.dima_md_ref(_t(d), _t(q), P, _t(cg), _t(ce),
                             *map(_t, noise), _t(vr))
    assert b[0].dtype == torch.int32 and b[1].dtype == torch.float32
    parity.check_outputs(a, b, vr, label=f"ref/{mode}")


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("mode", ["dp", "md"])
def test_batch_wrapper_matches_pallas(mode, trim):
    """dima_{dp,md}_batch on CPU tensors vs the Pallas kernel (interpret
    mode) on the same noise: B=3, M=256."""
    B, M = 3, 256
    d, qs = _words(1, M, 256), _words(2, B, 256)
    noise = [np.asarray(a) for a in
             jops._batch_noise(jax.random.PRNGKey(5), JP, B, M, mode)]
    vr = _window(mode)
    ep_j = jops._trim_ep(TRIM, jnp.asarray(qs)) if trim else None
    ep_t = tops._trim_ep(TRIM, _t(qs)) if trim else None
    cg, ce, mg, mo = _chip_np()
    if mode == "dp":
        a = jdp.dima_dp_batch(jnp.asarray(d), jnp.asarray(qs), cg, ce, mg,
                              mo, *noise, vr, ep_j, params=JP)
        b = tdp.dima_dp_batch(_t(d), _t(qs), _t(cg), _t(ce), _t(mg),
                              _t(mo), *map(_t, noise), _t(vr), ep_t,
                              params=P)
    else:
        a = jmd.dima_md_batch(jnp.asarray(d), jnp.asarray(qs), cg, ce,
                              *noise, vr, ep_j, params=JP)
        b = tmd.dima_md_batch(_t(d), _t(qs), _t(cg), _t(ce),
                              *map(_t, noise), _t(vr), ep_t, params=P)
    assert len(b) == (3 if trim else 2)
    assert tuple(b[0].shape) == (B, M)
    parity.check_outputs(a, b, vr, label=f"batch/{mode}/trim={trim}")
    assert tdp.launches == {"dima_dp_batch": 0, "dima_dp_bank_batch": 0}


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("mode", ["dp", "md"])
def test_bank_wrapper_matches_pallas(mode, trim):
    """dima_{dp,md}_bank_batch on CPU tensors vs the bank-leading Pallas
    kernel: NB=2 banks with their own ADC windows, B=2, M=128."""
    NB, B, M = 2, 2, 128
    d, qs = _words(3, NB, M, 256), _words(4, B, 256)
    noise = [np.asarray(a) for a in jops._stack_bank_noise(
        jax.random.PRNGKey(6), JP, NB, M, mode, B=B)]
    vr = np.concatenate([_window(mode), 0.8 * _window(mode)])
    ep_j = jops._trim_ep(TRIM, jnp.asarray(qs)) if trim else None
    ep_t = tops._trim_ep(TRIM, _t(qs)) if trim else None
    cg, ce, mg, mo = _chip_np()
    if mode == "dp":
        a = jdp.dima_dp_bank_batch(jnp.asarray(d), jnp.asarray(qs), cg, ce,
                                   mg, mo, *noise, vr, ep_j, params=JP)
        b = tdp.dima_dp_bank_batch(_t(d), _t(qs), _t(cg), _t(ce), _t(mg),
                                   _t(mo), *map(_t, noise), _t(vr), ep_t,
                                   params=P)
    else:
        a = jmd.dima_md_bank_batch(jnp.asarray(d), jnp.asarray(qs), cg, ce,
                                   *noise, vr, ep_j, params=JP)
        b = tmd.dima_md_bank_batch(_t(d), _t(qs), _t(cg), _t(ce),
                                   *map(_t, noise), _t(vr), ep_t, params=P)
    assert tuple(b[0].shape) == (NB, B, M)
    parity.check_outputs(a, b, vr.reshape(NB, 1, 2),
                         label=f"bank/{mode}/trim={trim}")


@pytest.mark.parametrize("mode", ["dp", "md"])
def test_ops_wrappers_match_jax_at_zero_noise(mode):
    """Every ops wrapper — padding, chip operands, trim packing — agrees
    with the JAX ops wrapper of the same name at zero noise (ragged
    M=100 pads to one 128-row block)."""
    d, qs = _words(8, 100, 256), _words(9, 2, 256)
    banks = _words(10, 3, 40, 256)
    jf = {n: getattr(jops, f"dima_{mode}_{n}") for n in
          ("banked", "matmat", "bank_matvec", "bank_matmat")}
    tf = {n: getattr(tops, f"dima_{mode}_{n}") for n in jf}
    vr = tuple(float(x) for x in _window(mode)[0])
    for name, args in (("banked", (d, qs[0])), ("matmat", (d, qs)),
                       ("bank_matvec", (banks, qs[0])),
                       ("bank_matmat", (banks, qs))):
        a = jf[name](*map(jnp.asarray, args), JP, CHIP_J, None, vr,
                     trim=TRIM)
        b = tf[name](*map(_t, args), P, CHIP_T, None, vr, trim=TRIM)
        parity.check_outputs(a, b, vr, label=f"{name}/{mode}")


@pytest.mark.parametrize("mode", ["dp", "md"])
def test_ref_at_zero_noise_matches_pipeline(mode):
    """Closing the loop inside the port: the plain kernel version with
    zero noise is the behavioral pipeline."""
    d, q = _words(11, 64, 256), _words(12, 256)
    chip = [CHIP_T[k] for k in tnoise.CHIP_KEYS]
    vr = torch.tensor(_window(mode)[0])
    if mode == "dp":
        b = tref.dima_dp_ref(_t(d), _t(q), P, *chip,
                             torch.zeros(64, 2, 128), torch.zeros(64, 2, 2),
                             vr)
        a = tpl.dima_dot(_t(d), _t(q), P, CHIP_T, None, (vr[0], vr[1]))
    else:
        b = tref.dima_md_ref(_t(d), _t(q), P, *chip[:2],
                             *[torch.zeros(64, 2, 128)] * 3,
                             torch.zeros(64, 2), vr)
        a = tpl.dima_manhattan(_t(d), _t(q), P, CHIP_T, None, (vr[0], vr[1]))
    parity.check_outputs(a[:2], b, vr)


@pytest.mark.parametrize("mode", ["dp", "md"])
def test_noise_rule_query_and_bank_streams(mode):
    """The seeding rule: query j of a matmat draws what a single-query op
    under ``fold_in(gen, j)`` draws, and bank b of a fused bank launch
    what a single-bank op under ``fold_in(gen, b)`` draws — bitwise."""
    gen = torch.Generator().manual_seed(4)
    d, qs = _t(_words(13, 2, 128, 256)), _t(_words(14, 3, 256))
    one = getattr(tops, f"dima_{mode}_banked")
    mm = getattr(tops, f"dima_{mode}_matmat")(d[0], qs, P, CHIP_T, gen)
    for j in range(3):
        sj = one(d[0], qs[j], P, CHIP_T, tnoise.fold_in(gen, j))
        assert torch.equal(mm[1][j], sj[1]) and torch.equal(mm[0][j], sj[0])
    bank = getattr(tops, f"dima_{mode}_bank_matvec")(d, qs[0], P, CHIP_T,
                                                      gen)
    for b in range(2):
        sb = one(d[b], qs[0], P, CHIP_T, tnoise.fold_in(gen, b))
        assert torch.equal(bank[1][b], sb[1])
    # the op does not advance the parent: same generator, same noise
    again = getattr(tops, f"dima_{mode}_matmat")(d[0], qs, P, CHIP_T, gen)
    assert torch.equal(again[1], mm[1])
    # and the noise is there: volts move off the zero-noise values
    quiet = getattr(tops, f"dima_{mode}_matmat")(d[0], qs, P, CHIP_T, None)
    assert not torch.equal(quiet[1], mm[1])


def test_wrappers_reject_bad_operands():
    d, qs = torch.zeros(128, 256, dtype=torch.uint8), torch.zeros(
        2, 256, dtype=torch.uint8)
    chip = [CHIP_T[k] for k in tnoise.CHIP_KEYS]
    rn, cn = torch.zeros(2, 128, 2, 128), torch.zeros(2, 128, 2, 2)
    vr = torch.tensor([[0.0, 0.3]])
    tdp.dima_dp_batch(d, qs, *chip, rn, cn, vr)           # the valid call
    with pytest.raises(TypeError):
        tdp.dima_dp_batch(d.to(torch.int32), qs, *chip, rn, cn, vr)
    with pytest.raises(ValueError):
        tdp.dima_dp_batch(d, qs, *chip, rn[:, :100], cn, vr)
    with pytest.raises(ValueError):
        tdp.dima_dp_batch(d, qs, *chip, rn.transpose(0, 1).contiguous()
                          .transpose(0, 1), cn, vr)
    with pytest.raises(ValueError):
        tdp.dima_dp_bank_batch(d[None], qs, *chip, rn[None], cn[None],
                               torch.tensor([[0.0, 0.3], [0.0, 0.3]]))
    with pytest.raises(ValueError):                       # not cpu/cuda
        tmd.dima_md_batch(d.to("meta"), qs.to("meta"),
                          *[c.to("meta") for c in chip[:2]],
                          *[rn.to("meta")] * 3, cn[..., 0].to("meta"),
                          vr.to("meta"))
