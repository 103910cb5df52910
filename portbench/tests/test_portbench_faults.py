"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of a run is driven at the
tiny layout on the CPU, and ``correct`` is read against the limits of the
configuration file.  The faults a cell of this benchmark can have: a step
that returns its first outputs unchanged, half of the batch left out (its
rows the other half's), an answer altered where it is produced (the
panorama shifted by an eighth of its width, or one view's region of it
off by 3000, which the whole-panorama mean dilutes below its limit and the
worst tile shows), and, served, a caller handed another caller's row.  One card runs each cell, so no exchange between
chips can be left out."""

import time

import numpy as np
import pytest
import torch

import tiny
from tiny import cell

from portbench.harness import main, program
from portbench.harness.closed import Sampler


@pytest.mark.parametrize("k,batch", [(8, 8), (8, 1), (4, 4), (8, 3)])
def test_sample_covers_every_row_of_the_batch(k, batch):
    """However few steps the window holds, the check's sample has every
    row position of the batch in it (so half of the batch left out always
    shows), and ``k`` items once the window offered that many."""
    for steps in (1, 2, 50):
        if steps * batch < k:
            continue
        s = Sampler(k, batch, np.random.default_rng(3))
        for step in range(steps):
            for row in range(batch):
                s.offer(lambda step=step, row=row: (step, row), row)
        assert len(s.items) == k
        assert {row for _, row in s.items} == set(range(min(k, batch)))


def stale(full):
    first = []

    def run(*args):
        out = full(*args)
        if not first:
            first.append(tuple(t.clone() for t in out))
        return first[0]
    return run


def half(full):
    def run(*args):
        out, bases = full(*args)
        h = out.shape[0] // 2
        return (torch.cat([out[:h], out[:h]]), torch.cat([bases[:h],
                                                          bases[:h]]))
    return run


def altered(full):
    def run(*args):
        out, bases = full(*args)
        return torch.roll(out, out.shape[-1] // 8, -1), bases
    return run


def one_view(full):
    """A fifteenth of the panorama, a view's share, off by 3000 u16."""
    def run(*args):
        out, bases = full(*args)
        h, w = out.shape[-2:]
        o = out.to(torch.int32)
        box = o[..., h // 3:2 * h // 3, 2 * w // 5:3 * w // 5]
        box.copy_(torch.where(box < 32768, box + 3000, box - 3000))
        return o.to(out.dtype), bases
    return run


def _closed(monkeypatch, fault):
    build = program.build_e2e

    def broken(*a, **k):
        full, models, fuse = build(*a, **k)
        return (fault(full) if fault else full), models, fuse

    monkeypatch.setattr(program, "build_e2e", broken)
    c = cell("e2e_nf_b8")
    return main.run_cell(c, torch.device("cpu"), 2 ** 32 + 9, 5.0, False,
                         time.monotonic())


@pytest.fixture(scope="module")
def clean():
    mp = pytest.MonkeyPatch()
    try:
        return _closed(mp, None)
    finally:
        mp.undo()


@pytest.mark.parametrize("fault", [stale, half, altered])
def test_closed_loop_fault_is_not_correct(monkeypatch, clean, fault):
    out = _closed(monkeypatch, fault)
    assert out["attempted"] > 0 and out["correct"] is False
    gap = out["check"]["out_mean_u16"]
    assert gap["limit"] is not None and gap["value"] > gap["limit"]
    assert gap["value"] > 3 * clean["check"]["out_mean_u16"]["value"]


def test_one_view_fault_shows_in_the_worst_tile(monkeypatch, clean):
    out = _closed(monkeypatch, one_view)
    assert out["correct"] is False
    mean, tile = out["check"]["out_mean_u16"], out["check"]["out_tile_u16"]
    assert mean["value"] < mean["limit"] < tile["limit"] < tile["value"]
    assert clean["check"]["out_tile_u16"]["value"] < tile["limit"]


def test_served_rows_swapped_is_not_correct(monkeypatch):
    c = cell("serve_nf_poisson", rate_per_s=40.0, clients=16,
             warmup_steps=0)

    def swap(out, bases):
        return torch.roll(out, 1, 0), torch.roll(bases, 1, 0)

    monkeypatch.setattr(program, "artifact",
                        lambda *a, **k: tiny.Artifact(c, swap))
    out = main.run_cell(c, torch.device("cpu"), 11, 2.0, False,
                        time.monotonic())
    assert out["attempted"] == 80 and out["correct"] is False
    gap = out["check"]["out_mean_u16"]
    assert gap["value"] > gap["limit"]
