"""Guards of the port's rules: it imports neither ``jax`` nor anything of
``repro``, its entry points never fall back to the CPU on their own, and
nothing in it — no ``except``, no environment variable — can route a
CUDA tensor around the kernels."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import jax|from jax|import repro\b|from repro(\.| import))")

BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if v is not None
          and k.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not loaded, loaded
from repro_torch.core.applications import run_tm
r = run_tm(device="cpu")
assert r.acc_dima == r.acc_digital == 1.0, r
print(len(names))
"""


def _sources():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", BLOCKED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20        # every module imported


def test_no_jax_imports_no_fallbacks_in_sources():
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        rel = os.path.relpath(path, ROOT)
        for i, line in enumerate(text.splitlines(), 1):
            assert not FORBIDDEN_IMPORT.search(line), f"{rel}:{i}: {line}"
        # no handler that could swallow a failed build/launch, no switch
        # read from the environment
        assert not re.search(r"^\s*except\b", text, re.M), rel
        assert "os.environ" not in text and "getenv" not in text, rel


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device="cpu"`` an entry point asks for CUDA; with no
    card it raises instead of running on the CPU."""
    from repro_torch import convert
    from repro_torch.core import applications, noise
    from repro_torch.core.api import get_backend
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chip = noise.ideal_chip(device="cpu")
    for call in (lambda: applications.run_all(),
                 lambda: applications.run_mf(chip=chip),
                 lambda: get_backend("kernel"),
                 lambda: get_backend("multibank", inner="kernel"),
                 lambda: noise.sample_chip(torch.Generator()),
                 lambda: convert.chip_from_jax(chip),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
