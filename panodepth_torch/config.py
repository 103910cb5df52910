"""View-layout and pipeline configuration (numpy only).

Counterpart of ``panodepth/config.py``, kept as this package's own copy so
that nothing here imports the JAX package.

The reference hard-codes its perspective-view layouts behind compile-time
``if (true/false)`` blocks (reference ``Main.cpp:694-887``) and scatters the
solver constants across the code (zenith band ``Depth.cpp:22``, 1-degree
registration sampling ``Depth.cpp:1266-1268``, pyramid schedule
``Depth.cpp:1419-1424, 1649-1675``, output width ``Main.cpp:593``).  Here all
of that is a real, immutable configuration object.

Every layout is expressed as two ``(N, 4)`` tables:

* ``fovs``    — ``{azimuth_left, azimuth_right, zenith_top, zenith_down}`` of
  each perspective viewing window, radians (reference ``g_cubemap_FOVs``).
* ``ranges``  — the valid (fusion) sub-window of each view, radians
  (reference ``g_cubemap_ranges``).  NOTE: azimuth ranges may be *reversed*
  (left > right); the fusion bounding-box walks them with a negative x step
  (reference ``Depth.cpp:1503-1511``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

D2R = math.pi / 180.0

# Valid zenith band, radians (reference Depth.cpp:22: g_zenith_range).
ZENITH_RANGE = (26.0 * D2R, 154.0 * D2R)


def _five_fold(margin_deg: float, zen_windows, zen_ranges):
    """Build a 5-azimuth-column x 3-zenith-row layout.

    Mirrors the construction in reference Main.cpp:731-844: five 72-degree
    azimuth columns with +-margin overlap; three zenith rows.  The valid
    azimuth range of every view is (azi_hi - margin, azi_lo + margin), i.e.
    stored *reversed* exactly like the reference.
    """
    m = margin_deg * D2R
    azi = [(i * 72.0 * D2R - m, (i + 1) * 72.0 * D2R + m) for i in range(5)]
    fovs, ranges = [], []
    for (z0, z1), (Z0, Z1) in zip(zen_windows, zen_ranges):
        for a0, a1 in azi:
            fovs.append((a0, a1, z0 * D2R, z1 * D2R))
            ranges.append((a1 - m, a0 + m, Z0 * D2R, Z1 * D2R))
    return np.array(fovs, np.float64), np.array(ranges, np.float64)


@dataclasses.dataclass(frozen=True)
class ViewLayout:
    """A named set of perspective viewing windows + their valid fusion ranges."""

    name: str
    fovs: np.ndarray    # (N, 4) radians {azi_left, azi_right, zen_top, zen_down}
    ranges: np.ndarray  # (N, 4) radians {azi_a, azi_b, zen_top, zen_down}

    @property
    def num_views(self) -> int:
        return self.fovs.shape[0]

    def view_tag(self, i: int) -> str:
        """Filename tag ``<aziL>_<aziR>_<zenT>_<zenD>`` in rounded degrees.

        Matches the perspective-image naming convention of reference
        Main.cpp:313-315 (``%s.%d_%d_%d_%d.jpg``).
        """
        a0, a1, z0, z1 = (int(round(v / D2R)) for v in self.fovs[i])
        return f"{a0}_{a1}_{z0}_{z1}"


def five_fold_leres() -> ViewLayout:
    """Default layout: 15 views for LeReS (reference Main.cpp:788-844)."""
    fovs, ranges = _five_fold(
        3.0,
        zen_windows=[(18, 94), (52, 128), (86, 162)],
        zen_ranges=[(25, 60), (60, 120), (120, 155)],
    )
    return ViewLayout("5fold_leres", fovs, ranges)


def five_fold_midas() -> ViewLayout:
    """15 views for MiDaS (reference Main.cpp:731-787)."""
    fovs, ranges = _five_fold(
        2.0,
        zen_windows=[(20, 78), (61, 119), (102, 160)],
        zen_ranges=[(25, 67), (67, 113), (113, 155)],
    )
    return ViewLayout("5fold_midas", fovs, ranges)


def four_fold() -> ViewLayout:
    """12 views, 4 azimuth columns (reference Main.cpp:695-730)."""
    zen_windows = [(17, 109), (44, 136), (71, 163)]
    zen_ranges = [(25, 56), (56, 124), (124, 155)]
    azi_fov = [(-2, 92), (88, 182), (178, 272), (268, 362)]
    azi_rng = [(90, 0), (180, 90), (270, 180), (360, 270)]
    fovs, ranges = [], []
    for (z0, z1), (Z0, Z1) in zip(zen_windows, zen_ranges):
        for (a0, a1), (A0, A1) in zip(azi_fov, azi_rng):
            fovs.append((a0 * D2R, a1 * D2R, z0 * D2R, z1 * D2R))
            ranges.append((A0 * D2R, A1 * D2R, Z0 * D2R, Z1 * D2R))
    return ViewLayout("4fold", np.array(fovs, np.float64), np.array(ranges, np.float64))


def three_fold() -> ViewLayout:
    """9 views, 3 azimuth columns (reference Main.cpp:845-887)."""
    m = 2.0
    fovs, ranges = [], []
    azi = [(0 - m, 120 + m), (120 - m, 240 + m), (240 - m, 360 + m)]
    zen_windows = [(12, 120), (36, 144), (60, 168)]
    zen_ranges = [(26, 60), (60, 120), (120, 154)]
    for (z0, z1), (Z0, Z1) in zip(zen_windows, zen_ranges):
        for a0, a1 in azi:
            fovs.append((a0 * D2R, a1 * D2R, z0 * D2R, z1 * D2R))
            ranges.append(((a1 - m) * D2R, (a0 + m) * D2R, Z0 * D2R, Z1 * D2R))
    return ViewLayout("3fold", np.array(fovs, np.float64), np.array(ranges, np.float64))


LAYOUTS = {
    "5fold_leres": five_fold_leres,
    "5fold_midas": five_fold_midas,
    "4fold": four_fold,
    "3fold": three_fold,
}


def _cround(v: float) -> int:
    """C round(): half away from zero (numpy rounds half to even)."""
    return int(np.floor(v + 0.5)) if v >= 0 else int(np.ceil(v - 0.5))


def validate_layout(layout: ViewLayout,
                    out_widths: Tuple[int, ...] = (2048,)) -> None:
    """Raise ValueError (naming the bad view) for unusable layouts.

    A view whose azimuth range rounds to a single pixel column at any
    pyramid level has an empty fusion footprint — the reference's bbox
    walk would loop forever on it (``Depth.cpp:1503-1511`` steps x from
    x0 until x1 exclusive, so x0 == x1 never terminates); our dense plan
    used to die on a bare assert deep inside plan building (fusion
    view_bbox).  Checked here at configuration time instead.
    """
    if layout.fovs.shape != layout.ranges.shape or \
            layout.fovs.ndim != 2 or layout.fovs.shape[1] != 4 or \
            layout.fovs.shape[0] < 1:
        raise ValueError(
            f"layout {layout.name!r}: fovs/ranges must both be (N>=1, 4), "
            f"got fovs {layout.fovs.shape} ranges {layout.ranges.shape}")
    lim = 359.9 * D2R
    for out_width in out_widths:
        widths = [out_width // 2 ** l
                  for l in range(len(jacobi_schedule(out_width)))]
        for v in range(layout.ranges.shape[0]):
            r0, r1 = (min(layout.ranges[v, 0], lim),
                      min(layout.ranges[v, 1], lim))
            for w in widths:
                x0 = _cround(r0 / (2 * math.pi) * (w - 1))
                x1 = _cround(r1 / (2 * math.pi) * (w - 1))
                x0c = min(max(x0, 0), w - 1)
                x1c = min(max(x1, 0), w - 1)
                if x0c == x1c:
                    raise ValueError(
                        f"layout {layout.name!r} view {v} "
                        f"({layout.ranges[v, 0] / D2R:.3f}deg.."
                        f"{layout.ranges[v, 1] / D2R:.3f}deg): azimuth "
                        f"range rounds to a single pixel column at "
                        f"pyramid width {w} (out_width {out_width}) — "
                        f"empty fusion footprint (the reference's bbox "
                        f"walk would never terminate on it)")


def register_layout(layout: ViewLayout) -> ViewLayout:
    """Register a custom layout so MergeConfig can refer to it by name.

    Validates basic shape sanity immediately; width-dependent footprint
    checks run again at MergeConfig construction (validate_layout).
    """
    validate_layout(layout, out_widths=())
    LAYOUTS[layout.name] = lambda: layout
    return layout


def layout_from_arrays(name: str, fovs, ranges) -> ViewLayout:
    """Register a layout given as two (N, 4) radian tables.

    The state the two packages share is the view layout; this takes a
    layout's arrays (for example a JAX ``ViewLayout``'s ``fovs``/``ranges``)
    and registers it here under ``name``, like :func:`register_layout`.
    """
    return register_layout(ViewLayout(name, np.array(fovs, np.float64),
                                      np.array(ranges, np.float64)))


def jacobi_schedule(out_width: int) -> Tuple[int, ...]:
    """Per-level Jacobi iteration counts, coarse to fine.

    Reference Depth.cpp:1419-1424 (3 levels below 4096 wide, else 4) and
    Depth.cpp:1654-1675 (iteration counts).
    """
    if out_width >= 4096:
        return (200, 150, 100, 50)
    return (200, 100, 50)


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    """Everything the merge pipeline needs besides the images themselves."""

    layout_name: str = "5fold_leres"
    out_width: int = 2048                      # reference Main.cpp:593
    zenith_range: Tuple[float, float] = ZENITH_RANGE
    reg_step_rad: float = 1.0 * D2R            # 1-deg grid, Depth.cpp:1266-1268
    jacobi_step: float = 0.5                   # Depth.cpp:1650
    jacobi_reg: float = 1e-4                   # Depth.cpp:1651
    clamp_lo: float = 1e-4                     # sample clamp, Depth.cpp:1353-1364
    align_way: int = 1                         # median alignment, Depth.cpp:935
    cap_depth: bool = True                     # 10 m cap, Depth.cpp:938

    def __post_init__(self):
        levels = len(jacobi_schedule(self.out_width))
        step = 2 ** levels  # width AND height (=width/2) must divide
        if self.out_width % step != 0 or self.out_width < step * 4:
            raise ValueError(
                f"out_width must be a multiple of {step} (pyramid with "
                f"{levels} levels; reference uses 2048/4096), got "
                f"{self.out_width}")
        if self.layout_name not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout_name!r}; "
                             f"have {sorted(LAYOUTS)}")
        validate_layout(self.layout, out_widths=(self.out_width,))

    @property
    def out_height(self) -> int:
        return self.out_width // 2

    @property
    def layout(self) -> ViewLayout:
        return LAYOUTS[self.layout_name]()

    @property
    def schedule(self) -> Tuple[int, ...]:
        return jacobi_schedule(self.out_width)

    def clamped_ranges(self) -> np.ndarray:
        """Valid ranges with azimuths clamped to <=359.9 deg.

        Mirrors reference Depth.cpp:783-786.
        """
        r = self.layout.ranges.copy()
        lim = 359.9 * D2R
        r[:, 0] = np.minimum(r[:, 0], lim)
        r[:, 1] = np.minimum(r[:, 1], lim)
        return r
