"""The dense transformer through its adapter (``archs/dense.py``) gives what
the harness gave when the architecture was written into it: values that
the earlier code computed, at fixed seeds, written here. Weights and
reference readings are pinned bit for bit (torch's CPU kernels give the
same bits at 1 and at 8 threads)."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from harness import data
from harness.cell import RankResult, assemble, reckoned_written_bytes
from harness.spec import load_cell
from harness.trace import summarize
from tinybench import REPO

CELLS = {"pythia-160m": "pythia-160m.sync_save", "pythia-410m": "pythia-410m.restart"}
PUBLISHED = {
    "pythia-160m": {"step_flops": 14002667126784.0, "state_bytes": 973324800, "leaf_count": 225,
                    "param_count": 162220800, "flash_chunk_bound_s": 5.2112848889787665e-05,
                    "tokens_per_step": 16384},
    "pythia-410m": {"step_flops": 19849191358464.0, "state_bytes": 2430375936, "leaf_count": 441,
                    "param_count": 405062656, "flash_chunk_bound_s": 3.4741899259858443e-05,
                    "tokens_per_step": 8192},
}
RECKONED = {"pythia-160m.async_save": 2919974400, "pythia-160m.sync_save": 2919974400,
            "pythia-160m.ddp4_sync_save": 2919974400, "pythia-410m.restart": 2430375936}
# At the tiny size, seed 2**31 + 12345: the sha256 of make_weights' sorted
# fingerprints, and of one reference run over the feed's first two batches
# (json of its losses, first gradient norms and changes, keys sorted).
SEED = 2**31 + 12345
TINY_WEIGHTS = "23934fe8c4b31ff512440affd38f2b603759c7649ad857ba69520ee9336ff90f"
TINY_READINGS = "be9862933a7a31f70475c884fc05ea666d225de464d475ac330722340333871c"
TINY_LOSSES = [6.6949989795684814, 6.619795799255371]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_published_arithmetic(config):
    cell = load_cell(REPO, CELLS[config])
    d, arch, want = cell.dims, cell.arch, PUBLISHED[config]
    assert arch.step_flops(d) == want["step_flops"]
    assert arch.state_bytes(d) == want["state_bytes"]
    assert arch.leaf_count(d) == want["leaf_count"]
    assert arch.param_count(d) == want["param_count"]
    assert [k.bound_s for k in arch.kernels(d) if k.name == "flash_chunk"] == [want["flash_chunk_bound_s"]]


@pytest.mark.parametrize("cell", sorted(RECKONED))
def test_record_and_reckoned_bytes(cell):
    c = load_cell(REPO, cell)
    rec = assemble(c, [RankResult(rank=0, window_s=20.0)])
    want = PUBLISHED[c.config_name]
    assert rec["tokens_per_step"] == want["tokens_per_step"]
    assert rec["flops_per_step"] == want["step_flops"]
    assert rec["flash_chunk_bound_s"] == want["flash_chunk_bound_s"]
    assert reckoned_written_bytes(c) == RECKONED[cell]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_tiny_weights_and_reference_readings(tiny_root, config):
    cell = load_cell(tiny_root, CELLS[config])
    d, cpu, adamw = cell.dims, torch.device("cpu"), cell.config["run"]["adamw"]
    weights = cell.weights(SEED, cpu)
    got = hashlib.sha256(repr(sorted(data.fingerprints(weights).items())).encode()).hexdigest()
    assert got == TINY_WEIGHTS
    feed = data.TokenFeed(d, SEED, cpu)
    r = cell.reference.train_readings(weights, [feed.next(), feed.next()], d, adamw["lr"], adamw["betas"],
                                      adamw["eps"], adamw["weight_decay"])
    assert r.losses == TINY_LOSSES
    readings = {"losses": r.losses, "grad_norms": r.grad_norms, "change_norms": r.change_norms}
    assert hashlib.sha256(json.dumps(readings, sort_keys=True).encode()).hexdigest() == TINY_READINGS


def _is_flash_chunk_before(name):
    """How the harness picked the chunk kernel before the kernel table."""
    kernel = "flash_wgmma_kernel"
    if kernel not in name:
        return False
    args = name.split(kernel + "<", 1)[-1].split(">(", 1)[0]
    return args.replace(" ", "").endswith(",false>") or args.replace(" ", "").endswith(",false")


NAMES = [
    "void (anonymous namespace)::flash_wgmma_kernel<(anonymous namespace)::hopper::Bf16<64>, true, false>(Params)",
    "void (anonymous namespace)::flash_wgmma_kernel<(anonymous namespace)::hopper::Bf16<64>, true, true>(Params)",
    "void (anonymous namespace)::flash_wgmma_kernel<(anonymous namespace)::hopper::Tf32<128>, false, false>(Params)",
    "flash_wgmma_kernel<Cfg, true, false>(Params)", "flash_wgmma_kernel<Cfg, true,false>", "flash_wgmma_kernel<Cfg,true , false >",
    "flash_wgmma_kernel<Cfg, false, true>", "flash_wgmma_kernel<Cfg, false>(int, bool false)",
    "flash_wgmma_kernel<Cfg, true, false>, int>(x)", "_anonymous_namespace_::flash_wgmma_kernel__anonymou",
    "(anonymous namespace)::hopper::bwd::flash_bwd_dkv_kernel(Maps, float2 const*, int)",
    "Memcpy DtoH (Device -> Pinned)", "ampere_sgemm_128x64_nn",
]


@pytest.mark.parametrize("name", NAMES)
def test_chunk_pattern_picks_what_the_harness_picked(name):
    cell = load_cell(REPO, "pythia-160m.sync_save")
    s = summarize([(0, 10, name)], 0, 10, [], cell.arch.kernels(cell.dims))
    assert s["flash_chunk_calls"] == int(_is_flash_chunk_before(name))
    assert s["flash_chunk_s"] == (10e-9 if _is_flash_chunk_before(name) else 0.0)
