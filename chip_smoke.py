#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and
hold every kernel to its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit, the torch/CUDA/Python versions; both
   CUDA kernels built from ``src/repro_torch/csrc`` with ``nvcc`` (one
   process per source, started together), with ``-Xptxas -v``;
2. each of the four kernel entry points (``dima_{dp,md}_batch``,
   ``dima_{dp,md}_bank_batch``) against its plain version on the card, on
   the same explicit noise, trim off, on and cancelling (terms near 1e7
   that sum to near 0, as a calibrated trim's do), at B=64 x M=4096, at the
   apps' B in {100, 64, 8} x M=128, at NB=32 x B in {1, 64} x M=128 and
   at a ragged B=100 x M=100 (``repro_torch.parity``: codes equal except
   within 1e-7 V of an ADC boundary, volts to 1e-7 V, trimmed to 1e-6 of
   the score scale);
3. the main path with every launch counter set to 0: the paper's four
   applications (``run_all(device="cuda")`` on the ``kernel`` backend)
   and the 32-bank 4096x256 trimmed matvec on ``multibank`` with the
   kernel inner, in DP (the flagship, exactly one launch) and MD mode;
   each app's gap to digital must stay within 1 point; every kernel
   call of that run is recorded and, after the counters are read, held
   to its plain version on the same operands by the rule of phase 2;
4. every kernel timed after warm-up, at the main path's shapes and at
   B=64 x M=4096: its device time from a ``torch.profiler`` trace, beside
   its plain version's device time, the per-call time of both with CUDA
   events (host work included), and its bound (bytes over 3.35 TB/s vs
   f32 operations over 67 TFLOP/s, the H100 SXM data-sheet peaks);
5. one JSON line of kernel records, the card's name and power limit, and
   the final ``{"ok": true, "device": ...}`` line.

Without a visible CUDA device it prints no result and exits 2.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
TRIM = (0.98, -0.5, 3.0)           # the JAX package's flagship trim
# c0*dot - 127.5*sum(q): terms near 1e7 cancel to a score near 0, as a
# calibrated trim does; an ulp of any intermediate shows in the result
CANCEL_TRIM = (1.0, -127.5, 0.0)
CHECK_TRIMS = {"off": None, "on": TRIM, "cancel": CANCEL_TRIM}
DEV = torch.device("cuda")
NO_LIBRARY = ("no single PyTorch call computes the analog chain "
              "(PWM transfer, BLP multiply, CBLP mean, ADC)")


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def sync():
    torch.cuda.synchronize(DEV)


class Kernels:
    """The four entry points with their plain versions and counters."""

    def __init__(self):
        from repro_torch.kernels import dima_dp, dima_md
        self.mods = {"dima_dp_batch": dima_dp, "dima_dp_bank_batch": dima_dp,
                     "dima_md_batch": dima_md, "dima_md_bank_batch": dima_md}

    def reset(self):
        for name, mod in self.mods.items():
            mod.launches[name] = 0

    def counts(self):
        return {name: mod.launches[name] for name, mod in self.mods.items()}

    @staticmethod
    def mode(name):
        return name.split("_")[1]

    @staticmethod
    def banked(name):
        return "bank" in name


def make_operands(name, nb, b, m, trim, p, chip, seed):
    """Explicit-noise operands of one kernel call, at the noise budget's
    real sigmas, on the card, with the trim triple ``trim`` or none.
    Bank k gets its own ADC window."""
    from repro_torch.core import pipeline as pl
    from repro_torch.kernels import ops
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    mode = Kernels.mode(name)

    def words(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g,
                             device=dev)

    def noise(sigma_mv, *shape):
        return sigma_mv * 1e-3 * torch.randn(shape, generator=g, device=dev)

    d, qs = words(nb, m, 256), words(b, 256)
    cg, ce, mg, mo = ops._chip_arrays(chip, p, dev)
    full = (255.0 * 255.0 * pl.dp_gain(p) if mode == "dp"
            else 255.0 * pl.md_gain(p))
    k = torch.arange(nb, device=dev, dtype=torch.float32)
    vr = torch.stack([0.002 * full * k / nb,
                      full * (0.55 + 0.45 * (k + 1) / nb)], 1).contiguous()
    if mode == "dp":
        rest = (mg, mo, noise(p.sigma_read_mv, nb, b, m, 2, 128),
                noise(p.sigma_cblp_mv, nb, b, m, 2, 2))
    else:
        rest = (noise(p.sigma_cmp_off_mv, nb, b, m, 2, 128),
                noise(p.sigma_read_mv, nb, b, m, 2, 128),
                noise(p.sigma_read_mv, nb, b, m, 2, 128),
                noise(p.sigma_cblp_mv, nb, b, m, 2))
    return (d, qs, cg, ce, *rest, vr, ops._trim_ep(trim, qs))


def call_kernel(name, ks, args, p):
    """The entry point on bank-leading operands (the batch forms take
    bank 0)."""
    fn = getattr(ks.mods[name], name)
    *ops_, vr, ep = args
    if ks.banked(name):
        return fn(*ops_, vr, ep, params=p)
    d, qs, *rest = ops_
    out = fn(d[0], qs, *[t[0] if t.dim() >= 4 else t for t in rest], vr,
             ep, params=p)
    return tuple(o[None] for o in out)


def call_plain(name, ks, args, p):
    *ops_, vr, ep = args
    return ks.mods[name].plain(*ops_, vr, ep, p)


def io_bytes_and_flops(name, ks, args, outs, trim):
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None)
    nbytes += sum(t.numel() * t.element_size() for t in outs)
    n_out = outs[0].numel()
    mod = ks.mods[name]
    flops = n_out * (mod.FLOPS_PER_OUTPUT + (mod.FLOPS_PER_TRIM if trim
                                             else 0))
    return nbytes, flops


def call_ms(fn, iters, warmup=3):
    """CUDA events around back-to-back calls: what a caller sees per call,
    host work (validation, allocation, launch) included."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_kernels(fn, iters=1):
    """The CUDA kernels ``iters`` calls of ``fn`` ran, from a
    ``torch.profiler`` (CUPTI) trace: [(name, device microseconds)]."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters, kernel=None):
    """Device time per call: the summed duration of the CUDA kernels
    ``fn`` ran; when ``kernel`` is given, the mean duration of the
    launches whose name holds it (a trace may drop an event, so the mean
    is over the launches it recorded; the caller counts the launches)."""
    fn()
    sync()
    evs = [(n, us) for n, us in cuda_kernels(fn, iters)
           if kernel is None or kernel in n]
    require(evs and (kernel is None or len(evs) <= iters),
            f"profiler recorded {len(evs)} CUDA kernels for {kernel or fn}")
    return sum(us for _, us in evs) / 1e3 / (iters if kernel is None
                                             else len(evs))


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build(["dima_dp", "dima_md"])
    for name, rep in reports.items():
        print(f"[build] {name}: {_build.library_path(name).name}")
        for line in rep.strip().splitlines():
            print(f"[build]   {line}")
    print(f"[build] nvcc for both sources: "
          f"{time.perf_counter() - t0:.1f} s")


CHECK_SHAPES = {   # (NB, B, M) per entry point; M=128 at the apps' B
    "dima_dp_batch": [(1, 64, 4096), (1, 100, 100), (1, 100, 128),
                      (1, 64, 128), (1, 8, 128)],
    "dima_md_batch": [(1, 64, 4096), (1, 100, 100), (1, 100, 128),
                      (1, 64, 128), (1, 8, 128)],
    "dima_dp_bank_batch": [(1, 64, 4096), (32, 1, 128), (32, 64, 128),
                           (3, 100, 100)],
    "dima_md_bank_batch": [(1, 64, 4096), (32, 1, 128), (32, 64, 128),
                           (3, 100, 100)],
}


def phase_check(ks, p, chip):
    from repro_torch import parity
    max_err = {name: 0.0 for name in CHECK_SHAPES}
    seed = 100
    for name, shapes in CHECK_SHAPES.items():
        for nb, b, m in shapes:
            for trim_name, trim in CHECK_TRIMS.items():
                seed += 1
                args = make_operands(name, nb, b, m, trim, p, chip, seed)
                got = call_kernel(name, ks, args, p)
                sync()
                want = call_plain(name, ks, args, p)
                require(all(torch.isfinite(t).all() for t in got[1:]),
                        f"{name}: non-finite kernel output")
                n_edge = parity.check_outputs(
                    want, got, args[-2].reshape(nb, 1, 2),
                    label=f"{name} NB={nb} B={b} M={m} trim={trim_name}")
                err = float((got[1] - want[1]).abs().max())
                max_err[name] = max(max_err[name], err)
                print(f"[check] {name:20s} NB={nb:2d} B={b:3d} M={m:4d} "
                      f"trim={trim_name:6s} codes ok ({n_edge} differ at an "
                      f"ADC boundary), max |dV| {err:.2e} V")
                del args, got, want
    torch.cuda.empty_cache()
    return max_err


class Recorder:
    """Keeps a copy of the operands and outputs of every kernel call the
    main path makes through ``kernels/ops.py``, so that each call can be
    held to its plain version once the counters are read.  It stands in
    for the ops module's references to the four entry points and calls
    them unchanged: the launches and their counts are the entry points'
    own."""

    SLOTS = {"_dp_batch": "dima_dp_batch", "_md_batch": "dima_md_batch",
             "_dp_bank": "dima_dp_bank_batch",
             "_md_bank": "dima_md_bank_batch"}

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = {slot: getattr(ops, slot) for slot in self.SLOTS}
        for slot, name in self.SLOTS.items():
            setattr(ops, slot, self._wrap(name, self.saved[slot]))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for slot, fn in self.saved.items():
            setattr(ops, slot, fn)

    def _wrap(self, name, fn):
        def call(*args, params):
            out = fn(*args, params=params)
            self.calls.append((name, [None if a is None else a.clone()
                                      for a in args],
                               [o.clone() for o in out]))
            return out
        return call


def hold_main_path_calls(ks, calls, p, max_err):
    """Each recorded main-path kernel call — the apps' dataset words,
    zero-padded rows, calibrated ADC windows and generator noise —
    against its plain version on the same operands."""
    from repro_torch import parity
    seen = {}
    for name, args, got in calls:
        *ops_, vr, ep = args
        if not ks.banked(name):          # to the bank-leading layout
            d, qs, *rest = ops_
            ops_ = [d[None], qs, *[t[None] if t.dim() >= 3 else t
                                   for t in rest]]
            got = [o[None] for o in got]
        nb, b, m = ops_[0].shape[0], ops_[1].shape[0], ops_[0].shape[1]
        want = call_plain(name, ks, (*ops_, vr, ep), p)
        n_edge = parity.check_outputs(
            want, got, vr.reshape(nb, 1, 2),
            label=f"main-path {name} NB={nb} B={b} M={m}")
        err = float((got[1] - want[1]).abs().max())
        max_err[name] = max(max_err[name], err)
        n, edges, shapes = seen.get(name, (0, 0, set()))
        seen[name] = (n + 1, edges + n_edge,
                      shapes | {(nb, b, m, ep is not None)})
    for name, (n, edges, shapes) in sorted(seen.items()):
        print(f"[main] {name:20s} {n:3d} main-path calls == plain version "
              f"({edges} codes at an ADC boundary); (NB, B, M, trim) "
              f"{sorted(shapes)}")
    for name in ks.mods:
        require(name in seen, f"no main-path call of {name} was held to "
                              f"its plain version")


def phase_main_path(ks, p, max_err):
    from repro_torch.core import api, applications, noise
    from repro_torch.core import pipeline as pl
    from repro_torch import parity
    dev = DEV
    chip = noise.sample_chip(torch.Generator().manual_seed(7), p, dev)
    rng = np.random.default_rng(3)
    D = rng.integers(0, 256, (4096, 256)).astype(np.uint8)
    Q = rng.integers(0, 256, (256,)).astype(np.uint8)
    mb = api.get_backend("multibank", p, chip, device=dev, inner="kernel",
                         n_banks=32)
    flagship = {}

    ks.reset()
    with Recorder() as rec:
        t0 = time.perf_counter()
        res = applications.run_all(device=dev)
        sync()
        t_apps = time.perf_counter() - t0
        for mode in ("dp", "md"):
            before = ks.counts()
            out = mb.matvec(D, Q, mode=mode,
                            gen=torch.Generator(device=dev).manual_seed(11),
                            trim=TRIM)
            sync()
            after = ks.counts()
            flagship[mode] = (out, {k: after[k] - before[k] for k in after})
    counts = ks.counts()
    hold_main_path_calls(ks, rec.calls, p, max_err)
    del rec

    print(f"[main] run_all(device='cuda', backend='kernel'): "
          f"{t_apps:.2f} s host clock")
    print(f"[main] {'app':5s} {'acc_dima':>9s} {'acc_digital':>12s} "
          f"{'gap':>6s} {'pJ/dec':>9s} {'pJ/dec 32-bank':>15s} "
          f"{'pJ/dec digital':>15s}")
    for name, r in res.items():
        gap = abs(r.acc_dima - r.acc_digital)
        print(f"[main] {name:5s} {r.acc_dima:9.2f} {r.acc_digital:12.2f} "
              f"{100 * gap:5.1f}p {r.cost.energy_pj:9.1f} "
              f"{r.cost_mb.energy_pj:15.1f} {r.cost_conv.energy_pj:15.1f}")
        require(gap <= 0.01 + 1e-9,
                f"{name}: gap to digital {100 * gap:.1f} points > 1")
    for mode, (out, launched) in flagship.items():
        nz = {k: v for k, v in launched.items() if v}
        print(f"[main] 32-bank 4096x256 trimmed matvec ({mode}): launches "
              f"{nz}; {mb.decision_cost(256, mode=mode).energy_pj:.1f} "
              f"pJ/decision amortized")
        want = f"dima_{mode}_bank_batch"
        require(nz == {want: 1},
                f"the {mode} 32-bank matvec launched {nz}, expected "
                f"exactly one {want}")
        require(tuple(out.code.shape) == (4096,) and
                bool(torch.isfinite(out.trimmed).all()),
                f"{mode} 32-bank matvec output malformed")
    print(f"[main] launches over the main path: {counts}")
    for name, n in counts.items():
        require(n >= 1, f"{name} was not launched on the main path")

    # correctness on the card, after the counters were read: the
    # zero-noise 32-bank kernel op against the plain pipeline, and two
    # zero-noise apps on the card against the same apps on the CPU
    for mode in ("dp", "md"):
        full = (255.0 * 255.0 * pl.dp_gain(p) if mode == "dp"
                else 255.0 * pl.md_gain(p))
        got = mb.matvec(D, Q, mode=mode, trim=TRIM)
        want = api.get_backend("reference", p, chip, device=dev).matvec(
            D, Q, mode=mode, trim=TRIM)
        n_edge = parity.check_outputs(
            (want.code, want.volts, want.trimmed),
            (got.code, got.volts, got.trimmed), (0.0, full),
            label=f"32-bank {mode} vs reference")
        print(f"[main] 32-bank {mode} kernel op == plain pipeline at zero "
              f"noise ({n_edge} codes at an ADC boundary)")
    # where the main path's time goes: one more run_all under the profiler
    # (which inflates the host clock; the busy share is taken against the
    # un-profiled run above)
    t0 = time.perf_counter()
    evs = cuda_kernels(lambda: applications.run_all(device=dev))
    traced = time.perf_counter() - t0
    busy = sum(us for _, us in evs) / 1e6
    dima = sum(us for n, us in evs if "dima_" in n) / 1e6
    print(f"[main] run_all traced: {len(evs)} CUDA kernels, device busy "
          f"{1e3 * busy:.2f} ms = {100 * busy / t_apps:.2f} % of the "
          f"un-profiled {t_apps:.2f} s (idle {100 - 100 * busy / t_apps:.2f} "
          f"%); DIMA kernels {1e3 * dima:.3f} ms; traced wall "
          f"{traced:.2f} s")
    by_name = {}
    for n, us in evs:
        k = n if "dima_" not in n else n.split("_kernel")[0][-7:]
        c, t = by_name.get(k, (0, 0.0))
        by_name[k] = (c + 1, t + us)
    for n, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[main]   {t / 1e3:8.3f} ms in {c:5d} launches of {n[:70]}")
    chip_cpu = {k: v.cpu() for k, v in chip.items()}
    for fn in (applications.run_mf, applications.run_tm):
        on_card = fn(p, chip, None, device=dev)
        on_cpu = fn(p, chip_cpu, None, device="cpu")
        require(on_card.acc_dima == on_cpu.acc_dima,
                f"{on_card.name}: zero-noise acc {on_card.acc_dima} on the "
                f"card vs {on_cpu.acc_dima} on the CPU")
        print(f"[main] zero-noise {on_card.name}: acc_dima "
              f"{on_card.acc_dima:.2f} on the card == on the CPU")
    return counts, res


TIME_SHAPES = {   # main path's shape (NB, B, M, trim); at-scale shape
    "dima_dp_batch": ((1, 100, 128, True), (1, 64, 4096, False)),
    "dima_md_batch": ((1, 100, 128, False), (1, 64, 4096, False)),
    "dima_dp_bank_batch": ((32, 1, 128, True), (32, 64, 128, False)),
    "dima_md_bank_batch": ((32, 1, 128, True), (32, 64, 128, False)),
}


def time_one(name, ks, p, chip, nb, b, m, trim):
    args = make_operands(name, nb, b, m, TRIM if trim else None, p, chip,
                         seed=7)
    outs = call_kernel(name, ks, args, p)
    nbytes, flops = io_bytes_and_flops(name, ks, args, outs, trim)
    big = nb * b * m >= 1 << 16
    kernel = lambda: call_kernel(name, ks, args, p)
    plain = lambda: call_plain(name, ks, args, p)
    before = ks.counts()[name]
    ms = device_ms(kernel, 20, kernel=f"dima_{Kernels.mode(name)}_kernel")
    require(ks.counts()[name] - before == 21,
            f"{name}: not one launch per call while timed")
    plain_ms = device_ms(plain, 5)
    kernel_call = call_ms(kernel, 20 if big else 200)
    plain_call = call_ms(plain, 5 if big else 50, warmup=1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    rec = {"shape": {"NB": nb, "B": b, "M": m, "trim": trim},
           "ms": ms, "plain_ms": plain_ms, "call_ms": kernel_call,
           "plain_call_ms": plain_call, "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "share_of_bound": bound_ms / ms}
    print(f"[time] {name:20s} NB={nb:2d} B={b:3d} M={m:4d} trim="
          f"{str(trim):5s} kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"per call {kernel_call:.4f} / {plain_call:.4f} ms | "
          f"{nbytes / 1e6:.2f} MB {flops / 1e9:.3f} GFLOP | bound "
          f"{bound_ms:.4f} ms by {rec['bound_by']} | "
          f"{100 * rec['share_of_bound']:.1f}% of bound")
    del args, outs
    return rec


def phase_time(ks, p, chip, counts, max_err):
    replaces = {
        "dima_dp_batch": "src/repro/kernels/dima_dp.py:136",
        "dima_dp_bank_batch": "src/repro/kernels/dima_dp.py:196",
        "dima_md_batch": "src/repro/kernels/dima_md.py:122",
        "dima_md_bank_batch": "src/repro/kernels/dima_md.py:177",
    }
    records = []
    for name, (main, scale) in TIME_SHAPES.items():
        r_main = time_one(name, ks, p, chip, *main)
        r_scale = time_one(name, ks, p, chip, *scale)
        mode = Kernels.mode(name)
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/dima_{mode}.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": max_err[name], "ms": r_main["ms"],
            "plain_ms": r_main["plain_ms"], "call_ms": r_main["call_ms"],
            "plain_call_ms": r_main["plain_call_ms"],
            "bound_ms": r_main["bound_ms"],
            "bound_by": r_main["bound_by"], "library_ms": None,
            "library_note": NO_LIBRARY, "shape": r_main["shape"],
            "at_scale": r_scale})
    clocks = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,"
         "power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[time] after timing: sm clock, power draw, power limit, "
          f"temperature = {clocks}")
    print(f"[time] library_ms is null for every kernel: {NO_LIBRARY}")
    return records


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.core import noise
    from repro_torch.core.params import DimaParams

    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"Python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    p = DimaParams()
    ks = Kernels()
    chip = noise.sample_chip(torch.Generator().manual_seed(7), p, DEV)
    max_err = phase_check(ks, p, chip)
    counts, _ = phase_main_path(ks, p, max_err)
    records = phase_time(ks, p, chip, counts, max_err)
    print(f"[done] {time.perf_counter() - t0:.1f} s in all phases")
    print(json.dumps({"kernels": records}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
