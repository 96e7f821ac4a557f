"""The benchmark's own tests: ``python -m pytest bench/tests`` from the repo root.

They import the harness (``bench/``) and the port (``src/``); the cells'
small CPU versions use the port's smoke configurations, whose widths the
configuration dicts below repeat.
"""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def _smoke(name: str, **sizes) -> dict:
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf.update(program_smoke=True, param_dtype="float32", compute_dtype="float32", **sizes)
    return conf


@pytest.fixture
def olmoe_smoke() -> dict:
    """olmoe-1b-7b's smoke configuration (``repro_torch.configs.smoke_config``) in the file's form."""
    return _smoke("olmoe-1b-7b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=512, n_experts=8, top_k=8, d_ff_expert=64, max_seq=16)


@pytest.fixture
def rwkv_smoke() -> dict:
    return _smoke("rwkv6-1.6b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=512, rwkv_head_dim=16, decay_lora=8, mix_lora=8, chunk=16)


@pytest.fixture
def hetero_small() -> dict:
    mix = json.loads((BENCH / "traffic" / "hetero.json").read_text())
    mix.update(seq=16)
    return mix


@pytest.fixture
def backlog_small() -> dict:
    mix = json.loads((BENCH / "traffic" / "backlog.json").read_text())
    mix.update(slots=4, waiting=4, prompt_len=[5, 24], gen_len=[3, 9], sizes=8, check_requests=3)
    return mix


def small_context(cell: str, conf: dict, mix: dict, seed: int = 2**31 + 5, seconds: float = 0.3, plant=None):
    import torch
    from harness.cli import Context

    return Context({"name": cell, "chips": 1}, copy.deepcopy(conf), copy.deepcopy(mix), seed, seconds, False,
                   torch.device("cpu"), plant)
