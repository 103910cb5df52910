"""Whether what the timed path produced is correct: the sampled outputs
against the plain reference (``portbench/reference``), which recomputes
each sampled panorama from the same u8 input after the window has closed
and the program's state is freed.

Three numbers are compared, each the worst over the sampled panoramas:

- ``out_mean_u16``: the mean absolute gap of the u16 depth panorama, over
  all its pixels (the baseline net, extraction, the perspective net and
  its percentile, registration and fusion with the Jacobi behind it);
- ``out_tile_u16``: the largest mean absolute gap of the u16 panorama
  over the tiles of a 8 x 16 grid (128 x 128 pixels at 2048 wide), so a
  fault confined to one view's region, which the whole-panorama mean
  dilutes fifteen-fold, shows at its own size;
- ``base_mean``: the mean absolute gap of the baseline net's 0~1 map.

A gap that is not finite fails."""

from __future__ import annotations

import gc

import numpy as np
import torch

from ..reference.e2e import Reference

BLOCK = 4  # panoramas the reference runs at once
NAMES = ("out_mean_u16", "out_tile_u16", "base_mean")
TILES = (8, 16)  # rows x columns of the grid of ``out_tile_u16``


def tile_means(gap: np.ndarray) -> np.ndarray:
    """The mean of ``gap`` (H, W) over each tile of the ``TILES`` grid."""
    (r, c), (h, w) = TILES, gap.shape
    return gap.reshape(r, h // r, c, w // c).mean(axis=(1, 3))


def gaps(config: dict, root, samples, pool, device) -> dict:
    """{name: worst gap} of ``samples`` ((pool index, u16 out, baseline)
    each) against the reference on the same inputs."""
    ref = Reference(config, str(root), device)
    worst = dict.fromkeys(NAMES, 0.0)
    for lo in range(0, len(samples), BLOCK):
        block = samples[lo:lo + BLOCK]
        rgb = torch.from_numpy(np.stack([pool[i] for i, _, _ in block]))
        out, bases = ref(rgb)
        out, bases = out.cpu().numpy(), bases.cpu().numpy()
        for k, (_, got_out, got_base) in enumerate(block):
            d_px = np.abs(got_out.astype(np.float64) - out[k])
            d_base = np.abs(got_base.astype(np.float64)
                            - bases[k].astype(np.float64)).mean()
            for name, d in zip(NAMES, (d_px.mean(), tile_means(d_px).max(),
                                       d_base)):
                worst[name] = max(worst[name], float(d)) if np.isfinite(d) \
                    else float("inf")
    del ref
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return worst


def control_gaps(config: dict, root, samples, pool, device) -> dict:
    """The control's gaps: the reference computed one precision step below
    what the configuration states, put in the program's place on the same
    sampled inputs."""
    ctl = Reference(config, str(root), device, control=True)
    fake = []
    for lo in range(0, len(samples), BLOCK):
        block = samples[lo:lo + BLOCK]
        rgb = torch.from_numpy(np.stack([pool[i] for i, _, _ in block]))
        out, bases = ctl(rgb)
        fake += [(i, out[k].cpu().numpy(), bases[k].cpu().numpy())
                 for k, (i, _, _) in enumerate(block)]
    del ctl
    return gaps(config, root, fake, pool, device)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (and there is something to judge)."""
    if not numbers:
        return False
    return all(limits.get(k) is not None and v <= limits[k]
               for k, v in numbers.items())
