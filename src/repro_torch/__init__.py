"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

A package of its own beside the JAX reference: it imports torch and numpy,
never JAX and nothing of ``repro``.  Module names mirror the reference's, so
``repro_torch/models/attention.py`` is the counterpart of
``repro/models/attention.py``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.  What is ported so far is listed in ROADMAP.md.
"""
