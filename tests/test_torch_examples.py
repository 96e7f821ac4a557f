"""The port's examples (``python -m repro_torch.examples.<name> --device
cpu``) against the repo's ``examples/*.py`` on the JAX package, run through
``runpy`` with their output captured.  Each comparison takes every printed
field that depends neither on a model's random weights nor on wall time:
``hetero_adaptive_training`` every line; ``fault_tolerant_train`` the
steps, fleets, membership events and allocations; ``quickstart`` the
allocation trajectory, the simulated epoch times and ``frozen``;
``serve_decode`` the admit and finish ticks and the tokens per request."""

from __future__ import annotations

import contextlib
import importlib
import io
import re
import runpy
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def one_thread():
    """The examples' smoke models are small: one intra-op thread is several
    times faster than a thread per core for their tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name: str) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    return out.getvalue()


def _port(name: str) -> tuple[dict, str]:
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = mod.main(["--device", "cpu"])
    return result, out.getvalue()


def test_hetero_adaptive_training_prints_every_number_of_the_reference():
    want = _reference("hetero_adaptive_training")
    result, got = _port("hetero_adaptive_training")
    assert got == want
    assert f"{result['gain_vs_equal']:.1%}" in got
    assert result["adaptive_allocations"][0] == [10, 10, 10, 10] and len(result["adaptive_allocations"]) == 12
    assert all(sum(a) == 40 for a in result["adaptive_allocations"])


def _quickstart_lines(text: str) -> list[str]:
    return [re.sub(r"loss \S+", "loss *", ln) for ln in text.splitlines()]


def test_quickstart_allocations_and_frozen_equal_the_reference(one_thread):
    want = _quickstart_lines(_reference("quickstart"))
    result, got = _port("quickstart")
    assert _quickstart_lines(got) == want
    assert result["allocations"] == [[2, 2, 2, 2]] + [[3, 2, 2, 1]] * 4 and result["frozen"] is True
    assert all(loss == loss and loss < 10 for loss in result["losses"])


_FT_KEEP = ("===", "phase 1 ended", "resumed to step", "final allocation", "  membership change", "per-aggregation")


def _fault_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith(_FT_KEEP)]


def test_fault_tolerant_train_steps_fleets_events_and_allocations_equal_the_reference(one_thread):
    want = _fault_lines(_reference("fault_tolerant_train"))
    result, got = _port("fault_tolerant_train")
    assert _fault_lines(got) == want and len(want) == 8
    p1, p2 = result["phase1"], result["phase2"]
    assert p1["steps"] == 14 and p2["steps"] == 34 and p2["device"] == "cpu"
    assert p2["gpus"] == ["v100", "rtx2080ti", "v100", "v100"] and sum(p2["final_allocation"]) == 12
    assert [m["event"] for m in p2["memberships"]] == ["add@18", "replace@26"]


def _serve_lines(text: str) -> list[str]:
    return [re.sub(r"\(\S+ tok/s wall", "(* tok/s wall", ln) for ln in text.splitlines()]


def test_serve_decode_ticks_and_tokens_equal_the_reference(one_thread):
    want = _serve_lines(_reference("serve_decode"))
    result, got = _port("serve_decode")
    assert _serve_lines(got) == want and len(want) == 19
    for arch in ("smollm-360m", "rwkv6-1.6b", "jamba-1.5-large-398b"):
        reqs = result[arch]["requests"]
        assert [(r["t_admit"], r["t_finish"], r["tokens"]) for r in reqs] == [
            (0.0, 7.0, 8), (2.0, 15.0, 14), (7.0, 22.0, 16), (15.0, 21.0, 7), (21.0, 30.0, 10)]
    assert result["paged"] == {"req0_tokens": 32, "attended_key_tokens": 840, "dense_would_attend": 1488,
                               "ticks": 31}


def test_examples_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from repro_torch.examples import quickstart, serve_decode

    for mod in (quickstart, serve_decode):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.main([])
