"""The control comes out not correct: the plain reference computed in
float8 (the precision below the configurations' bfloat16), put in the
program's place, against the same reference in float32, under each
configuration's limits. On the CPU at a tiny size; on a card at the
cells' own size (``-m cuda_only``), beside the program, which passes."""

from __future__ import annotations

import json
import os

import pytest
import torch

from harness import check
from harness.cell import train_warmup
from harness.spec import load_cell
from tinybench import BENCH

CELLS = {"pythia-160m": "pythia-160m.sync_save", "pythia-410m": "pythia-410m.restart"}


def _limits(config):
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        return json.load(f)["limits"]


def _over(gaps, limits):
    return [k for k in limits if gaps[k] > limits[k]]


def _readings(cell, seed, device):
    d, a = cell.dims, cell.config["run"]["adamw"]
    t = train_warmup(cell, seed, device)
    program = (t.losses, t.grad_norms, t.change_norms)
    first, scale = t.first_moments, t.first_scale
    batches = [b.clone() for b in t.batches]
    del t

    def ref(compute):
        return cell.reference.train_readings(cell.weights(seed, device), batches, d, a["lr"], a["betas"],
                                             a["eps"], a["weight_decay"], compute=compute, keep_first_grads=True)

    f32, fp8 = ref("f32"), ref("fp8")
    return (check.training_gaps(*program, f32, first, scale),
            check.training_gaps(fp8.losses, fp8.grad_norms, fp8.change_norms, f32, fp8.first_grads))


@pytest.mark.parametrize("config", sorted(CELLS))
@pytest.mark.parametrize("seed", [3, 2**31 + 1])
def test_control_fails_and_program_passes_tiny(tiny_root, config, seed):
    limits = _limits(config)
    cell = load_cell(tiny_root, CELLS[config])
    program, control = _readings(cell, seed, torch.device("cpu"))
    assert not _over(program, limits), program
    assert _over(control, limits), control


@pytest.mark.cuda_only
@pytest.mark.parametrize("config", sorted(CELLS))
def test_control_fails_at_the_cells_size(card, config):
    from tinybench import REPO

    limits = _limits(config)
    cell = load_cell(REPO, CELLS[config])
    for seed in (11, 2**31 + 3, 5_000_000_007):
        program, control = _readings(cell, seed, card)
        assert not _over(program, limits), (seed, program)
        assert _over(control, limits), (seed, control)
        torch.cuda.empty_cache()
