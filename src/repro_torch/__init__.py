"""PyTorch/CUDA port of the DIMA reproduction (``repro``).

The package mirrors ``repro``'s module names — ``core.pipeline``,
``core.api``, ``kernels.ops`` and so on — with PyTorch idiom inside:
plain functions on tensors, an explicit ``device``, and an explicit
``torch.Generator`` (``gen``) wherever the JAX package takes a ``key``
(``gen=None`` is zero noise, as ``key=None`` is there).

Entry points (backends, the applications, ``noise.sample_chip``) run on
CUDA unless the caller passes ``device="cpu"``; without a card they
raise instead of falling back.  The two DIMA kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use.  A
kernel wrapper given CPU tensors runs the kernel's plain PyTorch version
(``kernels/ref.py``); given CUDA tensors it launches the kernel or
raises.

The package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``repro``.
"""
