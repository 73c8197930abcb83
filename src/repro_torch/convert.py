"""Carry state across from the JAX package's objects, given as plain
Python values and numpy arrays (this module imports neither ``jax`` nor
``repro``): a caller converts with ``dataclasses.asdict``, ``np.asarray``
and ``float`` on its side.  The tests use it so that both packages
compute with the same parameters, the same sampled chip and the same
trained SVM."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.noise import CHIP_KEYS
from repro_torch.core.params import DimaParams
from repro_torch.device import resolve_device


def params_from_jax(fields: dict) -> DimaParams:
    """``DimaParams`` from the JAX record's fields as a dict
    (``dataclasses.asdict``); an unknown or missing field raises."""
    return DimaParams(**fields)


def chip_from_jax(chip_record, device=None) -> dict:
    """A chip record (``col_gain``, ``cap_ratio_err``, ``mult_gain``,
    ``mult_off`` as arrays) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(chip_record[k], np.float32),
                            device=dev) for k in CHIP_KEYS}


def svm_from_jax(w, b):
    """A trained linear SVM ``(w, b)`` in the form ``run_svm(weights=...)``
    takes: float32 numpy weights and a Python float bias."""
    return np.asarray(w, np.float32), float(b)
