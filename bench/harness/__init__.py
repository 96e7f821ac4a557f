"""The benchmark harness of the PyTorch/CUDA port (``repro_torch``).

``bench/run.py`` is the entry; everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``metrics/<metric>.py``
and ``limits/<workload>.json``.  Nothing here imports JAX or the JAX package.
"""
