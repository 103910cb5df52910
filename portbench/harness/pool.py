"""Seeded u8 RGB panoramas: smooth colour fields with texture and noise,
made on the device in a few large calls and held in host memory, as a
decoder would hand them to the program.  No layer's work depends on the
pixels (the Jacobi's iteration counts, the normal equations and the exact
sort's percentile all have fixed cost), so every seed asks for the same
work."""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 8  # panoramas made per device call


def make_pool(seed: int, count: int, shape, device) -> np.ndarray:
    """(count, H, W, 3) u8 panoramas from ``seed`` (any non-negative
    integer below 2**63)."""
    h, w = shape
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    azi = torch.arange(w, device=dev, dtype=torch.float32) * (2 * math.pi
                                                              / w)
    zen = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) * (
        math.pi / h)
    azi, zen = azi[None, None, :], zen[None, :, None]
    out = np.empty((count, h, w, 3), np.uint8)
    for lo in range(0, count, CHUNK):
        n = min(CHUNK, count - lo)
        ph = torch.rand((6, n, 1, 1), generator=gen, device=dev) * (2 * math.pi)
        r = (0.5 + 0.25 * torch.sin(2 * azi + ph[0]) * torch.sin(zen)
             + 0.15 * torch.cos(3 * zen + ph[1]))
        g = (0.5 + 0.25 * torch.cos(azi + ph[2]) * torch.sin(2 * zen)
             + 0.1 * torch.sin(5 * azi + ph[3]))
        b = (0.45 + 0.3 * torch.cos(zen + ph[4])
             + 0.05 * torch.sin(9 * azi + 7 * zen + ph[5]))
        img = torch.stack([r, g, b], -1)
        img = img + 0.02 * torch.randn(img.shape, generator=gen, device=dev)
        u8 = (torch.clamp(img, 0, 1) * 255 + 0.5).to(torch.uint8)
        out[lo:lo + n] = u8.cpu().numpy()
    return out
