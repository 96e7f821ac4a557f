"""Runnable examples of the port, the counterparts of the repo's ``examples/``.

Each runs as ``python -m repro_torch.examples.<name> [--device cpu|cuda]``
(default ``cuda``) and returns from ``main(argv=None)`` a dict of what it
prints:

* ``quickstart`` — a reduced smollm trained by ``build_train_step`` under
  the paper's adaptive controller;
* ``hetero_adaptive_training`` — equal vs static vs adaptive allocation on a
  simulated heterogeneous cluster, and an elastic add (host-side only);
* ``fault_tolerant_train`` — the train CLI through a failure, a crash, an
  exact resume and a fleet upgrade;
* ``serve_decode`` — continuous batching over the three cache families, and
  the paged engine.
"""
