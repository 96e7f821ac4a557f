"""The frozen counts against the program's own at the cells' shapes, on the day they were frozen."""

import dataclasses
import json

import pytest
from conftest import BENCH

from harness import costs

CELLS = {  # configuration file -> the program's arch and the (kind, rows, seq) the cells run
    "olmoe-1b-7b": [("train", 1, 4096), ("prefill", 1, 2048), ("prefill", 1, 3584), ("decode", 32, 3000)],
    "rwkv6-1.6b": [("prefill", 1, 1024), ("prefill", 1, 3584), ("decode", 32, 2048)],
}


@pytest.mark.parametrize("name,kind,rows,seq", [(n, *s) for n, shapes in CELLS.items() for s in shapes])
def test_analytic_flops_is_the_programs(name, kind, rows, seq):
    from repro_torch.analysis.costmodel import analytic_flops
    from repro_torch.configs import get_config

    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    pcfg = dataclasses.replace(get_config(conf["program_arch"]), n_layers=conf["n_layers"])
    assert costs.analytic_flops(conf, kind, rows, seq) == analytic_flops(pcfg, kind, rows, seq)


def test_train_flops_without_recomputation_drop_one_forward():
    conf = json.loads((BENCH / "configs" / "olmoe-1b-7b.json").read_text())
    full = costs.analytic_flops(conf, "train", 1, 4096)
    plain = costs.analytic_flops(conf, "train", 1, 4096, remat=False)
    head = 3 * 2 * conf["d_model"] * conf["vocab_size"] * 4096
    assert (full - head) * 3 == (plain - head) * 4


def test_kernel_counts():
    import torch

    acc, g = [torch.zeros(10, dtype=torch.float32)], [torch.zeros(10, dtype=torch.bfloat16)]
    assert costs.weighted_accum_tree_cost(acc, g, None) == (20, 100, costs.PEAK_F32_FLOPS)
    r = torch.zeros(2, 64, 32, 64)
    flops, nbytes, _ = costs.rwkv6_scan_cost(r, r, r, r, torch.zeros(32, 64))
    assert flops == 6 * 2 * 64 * 32 * 64 * 64
    assert nbytes == 4 * r.numel() * 4 + 32 * 64 * 4 + r.numel() * 4 + 2 * 32 * 64 * 64 * 4
