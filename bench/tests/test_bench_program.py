"""The program's ranges in a device trace (harness/program.py), on a synthetic
event list: nested host ranges on two threads, the ranges' device-side twins,
and kernels matched to their launches by correlation id."""

import importlib.util

import pytest
import torch
from conftest import BENCH, ROOT

from harness import cli, program, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """The parts of a profiler event the harness reads."""

    def __init__(self, name, start, end, device=False, corr=0, tid=1, kind="cpu_op"):
        self._v = (name, start, end - start, device, corr, tid, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return CUDA if self._v[3] else CPU

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[6] in ("user_annotation", "gpu_user_annotation")


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("R", (), {"events": lambda _: events})()})()


# host ranges (name, start, end, thread): the step's thread and the autograd engine's
RANGES = [("repro.train.step", 10, 900, 1), ("repro.train.slot", 20, 600, 1), ("repro.train.forward", 30, 200, 1),
          ("repro.model.attn", 40, 100, 1), ("repro.train.backward", 300, 500, 1),
          ("repro.model.attn.bwd", 320, 400, 2), ("repro.train.optimizer", 700, 850, 1)]
# (launch time, thread, kernel start, kernel end)
KERNELS = [(50, 1, 100, 150), (150, 1, 150, 250), (350, 2, 350, 450), (450, 2, 460, 480), (750, 1, 760, 800),
           (950, 1, 950, 960)]


def _events(with_ranges=True):
    ev = [Ev("bench.span.traced", 0, 1000, kind="user_annotation"),
          Ev("bench.span.train.step", 0, 1000, kind="user_annotation")]
    for corr, (t, tid, s, e) in enumerate(KERNELS, start=1):
        ev.append(Ev("cudaLaunchKernel", t, t + 1, corr=corr, tid=tid, kind="cuda_runtime"))
        ev.append(Ev(f"kernel_{corr}", s, e, device=True, corr=corr, kind="kernel"))
    if with_ranges:
        for name, s, e, tid in RANGES:
            ev.append(Ev(name, s, e, tid=tid, kind="user_annotation"))
            ev.append(Ev(name, s + 5, e + 5, device=True, kind="gpu_user_annotation"))  # its device-side twin
    return sorted(ev, key=lambda x: x.start_ns())


def test_attribution_by_hand():
    got = program.summarize_program(Prof(_events()))
    ns = 1e-9
    assert got["program_s"] == pytest.approx({
        "repro.model.attn": 50 * ns, "repro.train.forward": 100 * ns, "repro.model.attn.bwd": 100 * ns,
        "repro.train.backward": 20 * ns, "repro.train.optimizer": 40 * ns})
    assert got["program_ops"] == {"repro.model.attn": 1, "repro.train.forward": 1, "repro.model.attn.bwd": 1,
                                  "repro.train.backward": 1, "repro.train.optimizer": 1}
    assert got["program_incl_ops"] == {"repro.train.step": 5, "repro.train.slot": 4, "repro.train.forward": 2,
                                       "repro.model.attn": 1, "repro.train.backward": 2, "repro.model.attn.bwd": 1,
                                       "repro.train.optimizer": 1}
    assert got["program_calls"] == {name: 1 for name, *_ in RANGES}
    # gaps (midpoint): 0-100 (50, attn), 250-350 (300, backward opens), 450-460 (455, backward),
    # 480-760 (620, step), 800-950 (875, step), 960-1000 (980, no range: the harness's span)
    assert got["program_gaps"] == pytest.approx({
        "repro.model.attn": 100 * ns, "repro.train.backward": 110 * ns, "repro.train.step": 430 * ns,
        "train.step": 40 * ns})


def test_the_summary_reads_the_same_with_and_without_the_ranges():
    with_ranges, without = trace.summarize(Prof(_events()), 1.0), trace.summarize(Prof(_events(False)), 1.0)
    assert with_ranges == without
    assert set(without) == {"kernel_s", "kernel_calls", "busy_s", "window_s", "device_ops", "idle_gaps",
                            "device_events"}
    assert without["device_events"] == len(KERNELS)
    idle = sum(v for _, v in program.summarize_program(Prof(_events()))["program_gaps"].items())
    assert idle == pytest.approx(sum(v for _, v in without["idle_gaps"]))


def test_the_readers_of_the_ranges():
    summary = {**trace.summarize(Prof(_events()), 1.0), **program.summarize_program(Prof(_events()))}
    record = {"trace": summary, "mix": {"traced_steps": 2},
              "steps": [{"moe_kept": 90.0, "moe_choices": 100.0}, {"moe_kept": 80.0, "moe_choices": 100.0}]}
    read = {name: cli._reader(name, ROOT)(record) for name, _ in program.METRICS}
    assert read == pytest.approx({"attn_ms.train": 1e3 * 150e-9 / 2, "moe_ms.train": None,
                                  "optimizer_ms.train": 1e3 * 40e-9 / 2, "launches_per_slot.train": 4.0})
    assert cli._reader("moe_kept_share.train", ROOT)(record) == pytest.approx(85.0)
    # a program without the ranges or the counter: every reader finds nothing
    bare = {"trace": trace.summarize(Prof(_events(False)), 1.0), "mix": {"traced_steps": 1},
            "steps": [{"loss": 1.0, "tokens": 8.0}]}
    for name in [n for n, _ in program.METRICS] + ["moe_kept_share.train"]:
        assert cli._reader(name, ROOT)(bare) is None, name


def test_the_range_runner_extends_the_summary_and_the_metrics(monkeypatch):
    monkeypatch.setattr(trace, "summarize", trace.summarize)
    monkeypatch.setattr(cli, "metrics_of", cli.metrics_of)
    spec = importlib.util.spec_from_file_location("bench_program_ranges", BENCH / "program_ranges.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    summary = trace.summarize(Prof(_events()), 1.0)
    assert summary["program_calls"]["repro.train.slot"] == 1 and summary["busy_s"] > 0
    cell = {"name": "train.olmoe-1b-7b.hetero"}
    record = {"trace": summary, "mix": {"traced_steps": 1}, "e2e": {"train_tokens_per_s": 1.0, "setup_s": 1.0}}
    spec = dict(cli.load_spec(), per_layer=[])  # the range metrics alone
    got = cli.metrics_of(spec, cell, record, True)
    assert got == {"attn_ms.train": {"value": pytest.approx(1.5e-4), "unit": "ms"},
                   "optimizer_ms.train": {"value": pytest.approx(4e-5), "unit": "ms"},
                   "launches_per_slot.train": {"value": 4.0, "unit": "count"}}
    assert cli.metrics_of(spec, cell, record, False) == {"train_tokens_per_s": {"value": 1.0, "unit": "tokens/s"},
                                                         "setup_s": {"value": 1.0, "unit": "s"}}
