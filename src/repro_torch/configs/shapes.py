"""Assigned input-shape set (same four shapes for every LM arch).

``train_*`` lowers ``train_step``; ``prefill_*`` lowers the prefill forward;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV/SSM
cache of ``seq_len``).  ``long_500k`` requires sub-quadratic context handling
and is skipped for pure full-attention archs (see DESIGN.md
§Arch-applicability); decode itself is O(S) per token for every family, so
the skip rule keys off the *family*, not the math of decode.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "runnable_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs allowed to run long_500k: sub-quadratic context (SSM / hybrid /
# mostly-local attention). Everything else skips it per the assignment.
LONG_CONTEXT_ARCHS = frozenset({"rwkv6-1.6b", "jamba-1.5-large-398b", "gemma3-27b"})


def runnable_shapes(arch_id: str) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_CONTEXT_ARCHS:
        names.append("long_500k")
    return names


def skip_reason(arch_id: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_ARCHS:
        return "pure full-attention arch: long_500k requires sub-quadratic attention (DESIGN.md)"
    return None
