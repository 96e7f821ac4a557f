"""The traffic generators: the copy of the program's synthesize, the backlog, the rows."""

import json

import numpy as np
import pytest
from conftest import BENCH

from harness import traffic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_synthesize_is_the_programs(seed):
    from repro_torch.serve.workload import WorkloadConfig, synthesize

    for rate in (0.0, 0.7):
        want = synthesize(WorkloadConfig(n_requests=12, rate=rate, prompt_len=(1024, 3584), gen_len=(64, 256),
                                         vocab_size=65536, seed=seed))
        got = traffic.synthesize(12, rate, (1024, 3584), (64, 256), 65536, seed)
        for w, g in zip(want, got, strict=True):
            assert (w.rid, w.max_gen, w.arrival) == (g["rid"], g["max_gen"], g["arrival"])
            assert np.array_equal(w.prompt, g["prompt"])


def test_backlog_gives_every_seed_the_same_sizes_in_another_order():
    mix = json.loads((BENCH / "traffic" / "backlog.json").read_text())
    runs = []
    for seed in (1, 2**31 + 3):
        b = traffic.Backlog(mix, 65536, seed)
        runs.append([b.next() for _ in range(mix["sizes"])])
    sizes = [sorted((len(p), g) for _, p, g in run) for run in runs]
    assert sizes[0] == sizes[1]
    assert [(len(p), g) for _, p, g in runs[0]] != [(len(p), g) for _, p, g in runs[1]]
    lens = [L for L, _ in sizes[0]]
    assert min(lens) >= mix["prompt_len"][0] and max(lens) <= mix["prompt_len"][1]
    gens = [g for _, g in sizes[0]]
    assert min(gens) >= mix["gen_len"][0] and max(gens) <= mix["gen_len"][1]
    # log-uniform: the median prompt lies near the geometric mean of the range
    assert abs(np.median(lens) - (1024 * 3585) ** 0.5) < 60
    again = traffic.Backlog(mix, 65536, 1)
    assert all(np.array_equal(p, q) and g == h for (_, p, g), (_, q, h) in zip(runs[0], (again.next() for _ in runs[0])))


def test_rows_differ_between_epochs_and_are_logged():
    rows = traffic.EpochRows(512, 16, 8, seed=3)
    a = rows.batch([0, 1])
    rows.epoch = 1
    b = rows.batch([0, 1])
    assert a["inputs"].shape == (2, 16) and not np.array_equal(a["inputs"], b["inputs"])
    assert np.array_equal(a["targets"][:, :-1], a["inputs"][:, 1:])
    assert rows.log == [(0, [0, 1]), (1, [0, 1])]
