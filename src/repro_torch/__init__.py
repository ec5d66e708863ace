"""Scavenger on PyTorch + CUDA: the port of the ``repro`` package.

``repro_torch.core.Store`` is the entry point.  This package imports
``torch`` and ``numpy`` only — nothing of JAX or of ``repro``.
"""
