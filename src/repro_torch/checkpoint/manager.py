"""Checkpoint lifecycle: retention, auto-resume, training-state bundling.

Bundles model params + optimizer state + the allocation controller's
state_dict + data-epoch position (the elastic driver's metadata carries
epoch, aggregation index and fleet membership), so a restart resumes *both*
the model and the paper's adaptive allocation where they left off (a
controller reset would re-run the 4–5 adaptation epochs after every
failure — measured by ``python -m benchmarks.run --scenario elastic``).
"""

from __future__ import annotations

import os
import re
from typing import Any

from repro_torch.checkpoint.checkpointer import restore_pytree, save_pytree

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, save_every: int = 100) -> None:
        self.directory = directory
        self.keep = keep
        self.save_every = save_every
        os.makedirs(directory, exist_ok=True)

    # -- discovery -----------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore --------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, state: Any, metadata: dict | None = None) -> str:
        path = save_pytree(self._step_dir(step), state, metadata=metadata)
        self._gc()
        return path

    def is_due(self, step: int) -> bool:
        """Single source of truth for the periodic-save cadence; callers that
        build metadata lazily should gate on this instead of re-deriving it."""
        return step % self.save_every == 0 and step > 0

    def save_if_due(self, step: int, state: Any, metadata: dict | None = None) -> str | None:
        if self.is_due(step):
            return self.save(step, state, metadata)
        return None

    def restore(self, like: Any, step: int | None = None) -> tuple[int, Any, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree, meta = restore_pytree(self._step_dir(step), like)
        return step, tree, meta

    def restore_or_init(self, like: Any) -> tuple[int, Any, dict]:
        """Auto-resume: latest checkpoint if any, else (0, like, {})."""
        if self.latest_step() is None:
            return 0, like, {}
        return self.restore(like)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            import shutil

            shutil.rmtree(self._step_dir(s), ignore_errors=True)
