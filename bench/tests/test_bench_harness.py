"""The harness on the CPU at small sizes: found by name, guarded, and its
comparison passing the program and failing the control and the faults."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, small_context

from harness import cli, compare, serve, train

TRAIN_CELL = "train.olmoe-1b-7b.hetero"
SERVE_CELL = "serve.rwkv6-1.6b.backlog"


def _verdict(record, cell):
    ok, _ = compare.judge(record["values"], compare.limits(ROOT, cell))
    return ok


def test_forbidden_names_are_compared_whole(monkeypatch):
    import repro_torch  # noqa: F401  (its name begins with the JAX package's)

    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.dist", object())
    assert cli.forbidden_modules() == ["repro"]


def test_nothing_forbidden_after_a_small_serve_run(rwkv_smoke, backlog_small):
    serve.run(small_context(SERVE_CELL, rwkv_smoke, backlog_small, seconds=0.2))
    assert cli.forbidden_modules() == []


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = _run(["--workload", TRAIN_CELL, "--seed", "3", "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", SERVE_CELL, "--seed", "3", "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_dummy_cell_comes_from_new_files_alone(tmp_path):
    spec = cli.load_spec()
    (tmp_path / "bench" / "configs").mkdir(parents=True)
    (tmp_path / "bench" / "traffic").mkdir()
    (tmp_path / "bench" / "metrics").mkdir()
    (tmp_path / "bench" / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy", "n_layers": 1}))
    (tmp_path / "bench" / "traffic" / "dummy-mix.json").write_text(json.dumps({"kind": "serve_closed", "slots": 2}))
    (tmp_path / "bench" / "metrics" / "dummy_share.serve.py").write_text(
        "def read(run):\n    return 100.0 * run['tokens'] / run['window_s']\n")
    spec["configs"].append({"name": "dummy", "source": "https://example.org", "file": "bench/configs/dummy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "serve.dummy.dummy-mix", "config": "dummy", "traffic": "dummy-mix",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "serve_tokens_per_s", "unit": "tokens/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["serve.dummy.dummy-mix"]})
    spec["per_layer"].append({"name": "dummy_share.serve", "unit": "%", "better": "higher", "source": "host_clock",
                              "layer": "engine", "moves": "serve_tokens_per_s",
                              "workloads": ["serve.dummy.dummy-mix"]})
    cell, conf, mix = cli.resolve(spec, "serve.dummy.dummy-mix", root=tmp_path)
    assert (conf["name"], mix["slots"]) == ("dummy", 2)
    record = {"tokens": 30, "window_s": 2.0, "e2e": {"serve_tokens_per_s": 15.0, "setup_s": 1.0}}
    assert cli.metrics_of(spec, cell, record, False, root=tmp_path) == {
        "serve_tokens_per_s": {"value": 15.0, "unit": "tokens/s"}, "setup_s": {"value": 1.0, "unit": "s"}}
    assert cli.metrics_of(spec, cell, record, True, root=tmp_path) == {"dummy_share.serve": {"value": 1500.0,
                                                                                            "unit": "%"}}


def test_every_metric_has_a_reader_and_every_cell_its_files():
    spec = cli.load_spec()
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for cell in spec["workloads"]:
        cli.resolve(spec, cell["name"])
        assert compare.limits(ROOT, cell["name"]), cell["name"]


def test_small_train_cell_matches_the_reference(olmoe_smoke, hetero_small):
    record = train.run(small_context(TRAIN_CELL, olmoe_smoke, hetero_small))
    assert record["attempted"] >= 1 and record["failed"] == 0
    assert all(v < 1e-5 for k, v in record["values"].items() if not k.startswith("_"))
    assert _verdict(record, TRAIN_CELL)


def _frozen_state(trainer):
    inner = trainer.step_fn

    def step(state, batch):
        params = [p.detach().clone() for p in state["params"].parameters()]
        moments = {k: [t.clone() for t in state["opt"][k]] for k in ("mu", "nu")}
        new, metrics = inner(state, batch)
        with torch.no_grad():
            for p, old in zip(new["params"].parameters(), params):
                p.copy_(old)
            for k, ts in moments.items():
                for t, old in zip(new["opt"][k], ts):
                    t.copy_(old)
        return new, metrics

    trainer.step_fn = step


def _half_batch(trainer):
    inner = trainer.step_fn

    def step(state, batch):
        alloc = np.asarray(batch["alloc"])
        return inner(state, dict(batch, alloc=alloc // 2))

    trainer.step_fn = step


@pytest.mark.parametrize("fault", [_frozen_state, _half_batch])
def test_small_train_cell_fails_a_broken_step(olmoe_smoke, hetero_small, fault):
    record = train.run(small_context(TRAIN_CELL, olmoe_smoke, hetero_small, plant=fault))
    assert not _verdict(record, TRAIN_CELL)


def test_small_serve_cell_matches_the_reference(rwkv_smoke, backlog_small):
    record = serve.run(small_context(SERVE_CELL, rwkv_smoke, backlog_small, seconds=0.5))
    assert record["attempted"] >= 3 and record["readings"]["short_answers"] == 0
    assert record["values"]["logit_gap"] < 1e-4
    assert _verdict(record, SERVE_CELL)
    # the serving readers (the cell waits outside BENCHMARK.json, PERF.md section 7)
    for name in ("ttft_p90_ms.serve", "queue_ms_p50.serve", "tick_ms_p50.serve", "prefill_ms_p50.serve",
                 "mfu.serve"):
        assert cli._reader(name, ROOT)(record) > 0, name


def _altered_tokens(engine):
    inner = engine._sample
    calls = [0]

    def sample(logits):
        calls[0] += 1
        tok = inner(logits)
        return (tok + 1) % logits.shape[-1] if calls[0] % 3 == 0 else tok

    engine._sample = sample


def test_small_serve_cell_fails_altered_tokens(rwkv_smoke, backlog_small):
    record = serve.run(small_context(SERVE_CELL, rwkv_smoke, backlog_small, seconds=0.5, plant=_altered_tokens))
    assert not _verdict(record, SERVE_CELL)


@pytest.mark.parametrize("seed", [5, 11])
def test_the_fp8_control_and_a_half_batch_fail_at_a_small_size(olmoe_smoke, hetero_small, seed):
    import control

    read = control.train_readings(dict(olmoe_smoke, n_layers=4), hetero_small, seed, torch.device("cpu"))
    for name in ("control", "half_batch"):
        assert not compare.judge(read[name], compare.limits(ROOT, TRAIN_CELL))[0], read


def test_the_serving_control_reads_further_from_the_reference_than_the_program(rwkv_smoke, backlog_small):
    import control

    program = serve.run(small_context(SERVE_CELL, rwkv_smoke, backlog_small, seconds=0.5))
    read = control.serve_readings(rwkv_smoke, dict(backlog_small, check_requests=2), 2**31 + 9, torch.device("cpu"))
    assert read["control"]["logit_gap"] > 100 * max(program["values"]["logit_gap"], 1e-4), read
