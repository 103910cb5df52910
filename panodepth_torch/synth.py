"""Procedural synthetic scenes with analytic ground-truth depth.

Counterpart of ``panodepth/synth.py``: indoor-style scenes (an axis-aligned
room, or two joined, around the camera, with sphere, box and cylinder
furniture, procedural textures and simple shading) rendered analytically,
so that every ray's depth is exact geometry and ground truth is free.  It
replaces the external datasets the reference's CNNs were trained on
(reference ``Main.cpp:465-474``).

* The scene and window samplers (``sample_scene`` v1 / v2 / mix,
  ``stack_scenes``, ``sample_view_fov``) are host numpy on a
  ``RandomState``, copied from the JAX package so that a seed draws the
  same scenes bit for bit.
* The renderer (``render_pano``, ``render_view``) is dense masked PyTorch
  over the fixed object table, on the device, for a batch of scenes at
  once (``scene_tensors``); ``v2=False`` skips the v2 feature blocks, which
  are exact no-ops on v1 scenes.  Ray directions are f32, as JAX computes
  them, through the port's ``geometry`` with ``xp=torch``.
* ``synth_batches`` yields ``(rgb, depth, valid)`` training batches on the
  device, drawing the next batch's scene parameters on a host thread.
* ``write_dataset`` / ``main`` write ``rgb/synth_NNNN.jpg`` +
  ``gt/synth_NNNN.png`` with the port's own JPEG and PNG writers:

    python -m panodepth_torch.synth COUNT OUTDIR [--width 2048] [--scenes v1]

Depth follows the Matterport u16 convention: 0~1 value = meters * 4000 /
65535 (reference ``Depth.cpp:2001-2002``).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry

MAX_SPHERES = 6
MAX_BOXES = 8
MAX_CYLS = 4
# object table order: [room shell, spheres, boxes, cylinders] — cylinders
# come LAST so v1 scenes (cylinders off) keep their original object indices
N_OBJ = 1 + MAX_SPHERES + MAX_BOXES + MAX_CYLS
_N_OBJ_V1 = 1 + MAX_SPHERES + MAX_BOXES

METERS_TO_01 = 4000.0 / 65535.0


class Scene(NamedTuple):
    """One scene's parameters (all f32; batch by stacking a leading axis)."""

    room_lo: np.ndarray      # (3,) room min corner (camera at the origin)
    room_hi: np.ndarray      # (3,)
    sph_c: np.ndarray        # (MAX_SPHERES, 3)
    sph_r: np.ndarray        # (MAX_SPHERES,)
    sph_on: np.ndarray       # (MAX_SPHERES,) 1.0/0.0
    box_lo: np.ndarray       # (MAX_BOXES, 3)
    box_hi: np.ndarray       # (MAX_BOXES, 3)
    box_on: np.ndarray       # (MAX_BOXES,)
    wall_color: np.ndarray   # (6, 3) per-face room albedo
    obj_c1: np.ndarray       # (N_OBJ, 3) texture colors
    obj_c2: np.ndarray       # (N_OBJ, 3)
    tex_kind: np.ndarray     # (N_OBJ,) int32: 0 solid, 1 checker, 2 stripes,
    #                          3 marble, 4 rings, 5 dots, 6 noise (4-6: v2)
    tex_scale: np.ndarray    # (N_OBJ,)
    ambient: np.ndarray      # () base light level
    # --- v2 (scene-diversity) fields; v1 scenes carry exact no-op values ---
    room2_lo: np.ndarray     # (3,) attached second room box (L-shaped union)
    room2_hi: np.ndarray     # (3,)
    room2_on: np.ndarray     # () 1.0/0.0
    cyl_c: np.ndarray        # (MAX_CYLS, 2) vertical cylinder xy centers
    cyl_r: np.ndarray        # (MAX_CYLS,)
    cyl_z: np.ndarray        # (MAX_CYLS, 2) z extents (lo, hi)
    cyl_on: np.ndarray       # (MAX_CYLS,)
    light_p: np.ndarray      # (3,) point-light position
    light_i: np.ndarray      # () point-light intensity (0 = headlight only)
    tex_rot: np.ndarray      # (N_OBJ,) texture rotation about z (radians)


def _neutral_v2_fields(room_lo, room_hi):
    """v2 field values that render bit-identically to the pre-v2 engine."""
    f32 = np.float32
    return dict(
        room2_lo=room_lo.copy(), room2_hi=room_hi.copy(),
        room2_on=f32(0.0),
        cyl_c=np.zeros((MAX_CYLS, 2), f32),
        cyl_r=np.full(MAX_CYLS, 0.05, f32),
        cyl_z=np.tile(np.array([0.0, 0.1], f32), (MAX_CYLS, 1)),
        cyl_on=np.zeros(MAX_CYLS, f32),
        light_p=np.array([0.0, 0.0, 1.0], f32), light_i=f32(0.0),
        tex_rot=np.zeros(N_OBJ, f32))


def _pad_obj(arr, fill):
    """Pad a per-object table drawn for the v1 object count up to N_OBJ."""
    pad = np.full((N_OBJ - _N_OBJ_V1,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def sample_scene(rng: np.random.RandomState, version=1) -> Scene:
    """Draw a random indoor-style scene.

    ``version`` selects the scene distribution: 1 (default) is the original
    convex-room engine — its rng stream and rendered output are unchanged,
    so committed zoo evals stay reproducible; 2 adds L-shaped rooms,
    corridors, vertical cylinders, floor-snapped furniture, three more
    texture families, texture rotation, and a point light; "mix" draws v1
    with probability 0.35, else v2.
    """
    if version in (2, "2", "v2"):
        return _sample_scene_v2(rng)
    if version == "mix":
        return (sample_scene(rng) if rng.rand() < 0.35
                else _sample_scene_v2(rng))
    if version not in (1, "1", "v1"):
        raise ValueError(f"unknown scene version {version!r}")
    return _sample_scene_v1(rng)


def _sample_scene_v1(rng: np.random.RandomState) -> Scene:
    """The original engine: one convex room, spheres + boxes, 4 textures.

    Rooms are 3~9 m across with the camera 1.0~1.8 m above the floor;
    furniture keeps >= 0.45 m clearance from the camera so depth is bounded
    away from zero (gt validity threshold 1e-4 ~ 0.16 m).
    """
    f32 = np.float32
    room_lo = np.array([-rng.uniform(1.5, 4.5), -rng.uniform(1.5, 4.5),
                        -rng.uniform(1.0, 1.8)], f32)
    room_hi = np.array([rng.uniform(1.5, 4.5), rng.uniform(1.5, 4.5),
                        rng.uniform(0.8, 2.2)], f32)

    def place(margin):
        # a point inside the room, away from the camera
        for _ in range(64):
            p = np.array([rng.uniform(room_lo[i] + margin,
                                      room_hi[i] - margin)
                          for i in range(3)], f32)
            if np.linalg.norm(p) > margin + 0.45:
                return p
        return np.array([room_hi[0] - margin - 0.1, 0.0, 0.0], f32)

    n_sph = rng.randint(1, MAX_SPHERES + 1)
    sph_c = np.zeros((MAX_SPHERES, 3), f32)
    sph_r = np.full(MAX_SPHERES, 0.1, f32)
    sph_on = np.zeros(MAX_SPHERES, f32)
    for i in range(n_sph):
        r = rng.uniform(0.15, 0.7)
        sph_c[i] = place(r)
        sph_r[i] = r
        sph_on[i] = 1.0

    n_box = rng.randint(2, MAX_BOXES + 1)
    box_lo = np.zeros((MAX_BOXES, 3), f32)
    box_hi = np.ones((MAX_BOXES, 3), f32) * 0.1
    box_on = np.zeros(MAX_BOXES, f32)
    for i in range(n_box):
        half = rng.uniform(0.15, 0.9, 3).astype(f32)
        c = place(float(np.max(half)))
        box_lo[i] = c - half
        box_hi[i] = c + half
        box_on[i] = 1.0

    def color():
        return rng.uniform(0.15, 0.95, 3).astype(f32)

    # draw per-object tables at the v1 object count (preserves the v1 rng
    # stream byte-for-byte), then pad the cylinder slots with constants
    wall_color = np.stack([color() for _ in range(6)])
    obj_c1 = _pad_obj(np.stack([color() for _ in range(_N_OBJ_V1)]), 0.5)
    obj_c2 = _pad_obj(np.stack([color() for _ in range(_N_OBJ_V1)]), 0.5)
    tex_kind = _pad_obj(rng.randint(0, 4, _N_OBJ_V1).astype(np.int32), 0)
    tex_scale = _pad_obj(rng.uniform(0.8, 5.0, _N_OBJ_V1).astype(f32), 1.0)
    return Scene(room_lo, room_hi, sph_c, sph_r, sph_on, box_lo, box_hi,
                 box_on, wall_color, obj_c1, obj_c2, tex_kind, tex_scale,
                 np.float32(rng.uniform(0.25, 0.45)),
                 **_neutral_v2_fields(room_lo, room_hi))


def _sample_scene_v2(rng: np.random.RandomState) -> Scene:
    """The diverse engine: corridors, L-shaped two-box rooms, vertical
    cylinders (columns / floor lamps), floor-snapped furniture, 7 texture
    families with rotation, and a point light.

    Distance bound: the farthest reachable point (corridor end + attached
    room) stays under the u16 depth encoding's 16.38 m ceiling.
    """
    f32 = np.float32
    corridor = rng.rand() < 0.25
    if corridor:
        long_ax = rng.randint(0, 2)
        ext = np.empty((2, 2), f32)    # [axis][lo, hi] half-extents
        ext[long_ax] = rng.uniform(3.5, 7.0, 2)
        ext[1 - long_ax] = rng.uniform(0.9, 1.8, 2)
    else:
        ext = rng.uniform(1.2, 6.0, (2, 2)).astype(f32)
    floor = -rng.uniform(1.0, 1.8)
    ceil = rng.uniform(0.8, 3.0)
    room_lo = np.array([-ext[0, 0], -ext[1, 0], floor], f32)
    room_hi = np.array([ext[0, 1], ext[1, 1], ceil], f32)

    fields = _neutral_v2_fields(room_lo, room_hi)
    if rng.rand() < (0.35 if corridor else 0.55):
        # attach a second room box beyond one vertical face; the doorway is
        # the shared-face cross-section of the attachment
        ax = rng.randint(0, 2)
        sgn = 1 if rng.rand() < 0.5 else -1
        depth2 = rng.uniform(2.0, 5.0)
        w2 = rng.uniform(1.5, 5.0)
        lo2, hi2 = room_lo.copy(), room_hi.copy()
        face = room_hi[ax] if sgn > 0 else room_lo[ax]
        if sgn > 0:
            lo2[ax], hi2[ax] = face - 0.2, face + depth2
        else:
            lo2[ax], hi2[ax] = face - depth2, face + 0.2
        oax = 1 - ax
        c = rng.uniform(room_lo[oax] + 0.5, room_hi[oax] - 0.5)
        # clamp the cross-section inside room 1's face so the only opening
        # of the union is the doorway itself (no slot windows through the
        # ceiling or side walls where the 0.2 m overlap would poke out)
        lo2[oax] = max(c - w2 / 2, float(room_lo[oax]))
        hi2[oax] = min(c + w2 / 2, float(room_hi[oax]))
        hi2[2] = min(rng.uniform(0.8, 2.8), float(ceil))
        fields.update(room2_lo=lo2, room2_hi=hi2, room2_on=f32(1.0))

    rooms = [(room_lo, room_hi)]
    if fields["room2_on"] > 0:
        rooms.append((fields["room2_lo"], fields["room2_hi"]))

    def pick_room():
        return rooms[1] if len(rooms) > 1 and rng.rand() < 0.35 else rooms[0]

    def place(margin, lo, hi, xy_clear=None, z=None):
        """A point inside [lo, hi] with per-axis margin (clamped so thin
        rooms stay feasible), either >= margin+0.45 m from the camera in
        3D, or — for floor-snapped objects at fixed ``z`` — in xy.
        Returns None when the room is too small to satisfy the camera
        clearance (the caller skips the object — never place one that
        could swallow the camera or break the |c_xy| > r invariant)."""
        for _ in range(64):
            p = np.empty(3, f32)
            for i in range(3):
                m = min(margin, 0.45 * (hi[i] - lo[i]))
                p[i] = rng.uniform(lo[i] + m, hi[i] - m)
            if z is not None:
                p[2] = z
            clear = (xy_clear if xy_clear is not None else margin) + 0.45
            dist = (np.linalg.norm(p[:2]) if z is not None
                    else np.linalg.norm(p))
            if dist > clear:
                return p
        return None

    n_sph = rng.randint(0, MAX_SPHERES + 1)
    sph_c = np.zeros((MAX_SPHERES, 3), f32)
    sph_r = np.full(MAX_SPHERES, 0.1, f32)
    sph_on = np.zeros(MAX_SPHERES, f32)
    for i in range(n_sph):
        r = rng.uniform(0.12, 0.8)
        lo, hi = pick_room()
        if rng.rand() < 0.45:  # resting on the floor
            p = place(r, lo, hi, xy_clear=r, z=float(lo[2]) + r)
        else:
            p = place(r, lo, hi)
        if p is None:
            continue
        sph_c[i] = p
        sph_r[i] = r
        sph_on[i] = 1.0

    n_box = rng.randint(1, MAX_BOXES + 1)
    box_lo = np.zeros((MAX_BOXES, 3), f32)
    box_hi = np.ones((MAX_BOXES, 3), f32) * 0.1
    box_on = np.zeros(MAX_BOXES, f32)
    for i in range(n_box):
        half = rng.uniform(0.12, 0.9, 3).astype(f32)
        if rng.rand() < 0.25:  # tall cupboard / shelf
            half[2] = rng.uniform(0.8, 1.3)
        lo, hi = pick_room()
        if rng.rand() < 0.6:   # resting on the floor
            c = place(float(np.max(half[:2])), lo, hi,
                      xy_clear=float(np.linalg.norm(half[:2])),
                      z=float(lo[2]) + float(half[2]))
        else:
            c = place(float(np.max(half)), lo, hi)
        if c is None:
            continue
        box_lo[i] = c - half
        box_hi[i] = c + half
        box_on[i] = 1.0

    n_cyl = rng.randint(0, MAX_CYLS + 1)
    cyl_c = np.zeros((MAX_CYLS, 2), f32)
    cyl_r = np.full(MAX_CYLS, 0.05, f32)
    cyl_z = np.tile(np.array([0.0, 0.1], f32), (MAX_CYLS, 1))
    cyl_on = np.zeros(MAX_CYLS, f32)
    for i in range(n_cyl):
        r = rng.uniform(0.08, 0.5)
        lo, hi = pick_room()
        p = place(r, lo, hi, xy_clear=r, z=float(lo[2]))
        if p is None:
            continue
        cyl_c[i] = p[:2]
        cyl_r[i] = r
        if rng.rand() < 0.4:   # full-height column
            cyl_z[i] = (lo[2], hi[2])
        else:                  # floor-standing (lamp / stool / bin)
            cyl_z[i] = (lo[2], lo[2] + rng.uniform(0.4, 1.4))
        cyl_on[i] = 1.0
    fields.update(cyl_c=cyl_c, cyl_r=cyl_r, cyl_z=cyl_z, cyl_on=cyl_on)

    def color():
        return rng.uniform(0.08, 0.98, 3).astype(f32)

    if rng.rand() < 0.4:  # plain plastered walls
        g = rng.uniform(0.55, 0.95)
        wall_color = np.clip(
            g + rng.uniform(-0.08, 0.08, (6, 3)), 0.0, 1.0).astype(f32)
    else:
        wall_color = np.stack([color() for _ in range(6)])
    obj_c1 = np.stack([color() for _ in range(N_OBJ)])
    obj_c2 = np.stack([color() for _ in range(N_OBJ)])
    tex_kind = rng.randint(0, 7, N_OBJ).astype(np.int32)
    tex_scale = rng.uniform(0.5, 6.0, N_OBJ).astype(f32)
    fields["tex_rot"] = rng.uniform(0.0, math.pi, N_OBJ).astype(f32)

    if rng.rand() < 0.7:  # ceiling point light
        fields.update(
            light_p=np.array([
                rng.uniform(0.6 * room_lo[0], 0.6 * room_hi[0]),
                rng.uniform(0.6 * room_lo[1], 0.6 * room_hi[1]),
                ceil - 0.25], f32),
            light_i=f32(rng.uniform(0.3, 1.1)))

    return Scene(room_lo, room_hi, sph_c, sph_r, sph_on, box_lo, box_hi,
                 box_on, wall_color, obj_c1, obj_c2, tex_kind, tex_scale,
                 np.float32(rng.uniform(0.15, 0.5)), **fields)


def stack_scenes(scenes: List[Scene]) -> Scene:
    """Batch a list of scenes into one leading axis (for vmap)."""
    return Scene(*(np.stack([getattr(s, f) for s in scenes])
                   for f in Scene._fields))


def scene_tensors(scene: Scene, device) -> Scene:
    """A stacked :class:`Scene` (numpy, leading batch axis) as tensors on
    ``device``."""
    return Scene(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in scene))


def _take(table, idx):
    """Per-scene lookup: ``table`` (B, N, *tail) at ``idx`` (B, *pix) ->
    (B, *pix, *tail)."""
    b, n, tail = table.shape[0], table.shape[1], table.shape[2:]
    flat = idx.reshape(b, -1)
    if tail:
        k = math.prod(tail)
        out = torch.gather(table.reshape(b, n, k), 1,
                           flat[..., None].expand(-1, -1, k))
    else:
        out = torch.gather(table, 1, flat)
    return out.reshape(idx.shape + tail)


def _pick(a, idx):
    """``take_along_axis(a, idx[..., None], -1)[..., 0]`` with ``a``
    broadcast to ``idx``'s leading shape."""
    a = a.expand(idx.shape + a.shape[-1:])
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _norm(v, keepdim=False):
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def _render_dirs(scene: Scene, d, v2: bool = True):
    """Trace unit-ray directions ``d`` (B or 1, *pix, 3) from the origin
    through the B scenes of ``scene`` (tensors, leading batch axis).

    Returns (rgb (B, *pix, 3) in 0~1, depth (B, *pix) in the 0~1
    Matterport encoding).  Every step is JAX's ``_render_dirs`` (dense
    masked math over the fixed object table, in its op order), with the
    scene's tables broadcast over the pixels.
    """
    npix = d.dim() - 2

    def at(a):  # (B, *rest) -> (B, 1 x npix, *rest)
        return a.reshape(a.shape[:1] + (1,) * npix + a.shape[1:])

    f32 = torch.float32
    dev = d.device
    nb = scene.room_lo.shape[0]
    eps = 1e-6
    big = 1e9

    # --- room shell: the exit distance per axis (sign-preserving clamp)
    safe_d = torch.where(d.abs() < 1e-9, torch.where(d >= 0, 1e-9, -1e-9), d)
    t_ax = torch.where(d >= 0, at(scene.room_hi) / safe_d,
                       at(scene.room_lo) / safe_d)
    t_room = t_ax.amin(-1)
    face_ax = t_ax.argmin(-1)

    # --- the attached second room (v2 L-shapes), gated by room2_on
    if v2:
        lo2, hi2 = at(scene.room2_lo), at(scene.room2_hi)
        p1 = d * t_room[..., None]
        t2_ax = torch.maximum(lo2 / safe_d, hi2 / safe_d)
        t2 = t2_ax.amin(-1)
        ins2 = ((p1 >= lo2 - 1e-4) & (p1 <= hi2 + 1e-4)).all(-1)
        use2 = (at(scene.room2_on) > 0) & ins2 & (t2 > t_room)
        t_room = torch.where(use2, t2, t_room)
        face_ax = torch.where(use2, t2_ax.argmin(-1), face_ax)

    d_face = _pick(d, face_ax)
    face_id = face_ax * 2 + (d_face >= 0).to(face_ax.dtype)

    # --- spheres: nearest positive quadratic root
    oc = -at(scene.sph_c)                                  # (B, .., S, 3)
    b = (d[..., None, :] * oc).sum(-1)                     # oc . d
    c2 = at((scene.sph_c * scene.sph_c).sum(-1) - scene.sph_r ** 2)
    disc = b * b - c2
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t_sph = torch.where(t0 > eps, t0, t1)
    t_sph = torch.where((disc > 0) & (t_sph > eps) & (at(scene.sph_on) > 0),
                        t_sph, big)

    # --- boxes: slab test from the origin
    t_a = at(scene.box_lo) / safe_d[..., None, :]          # (B, .., Bx, 3)
    t_b = at(scene.box_hi) / safe_d[..., None, :]
    t_near = torch.minimum(t_a, t_b).amax(-1)
    t_far = torch.maximum(t_a, t_b).amin(-1)
    hit = (t_near > eps) & (t_near <= t_far) & (at(scene.box_on) > 0)
    t_box = torch.where(hit, t_near, big)

    # --- vertical cylinders (v2): the xy quadratic within the z slab
    if v2:
        a_xy = torch.clamp_min((d[..., :2] ** 2).sum(-1), 1e-8)[..., None]
        b_xy = (d[..., None, :2] * at(scene.cyl_c)).sum(-1)
        c_xy = at((scene.cyl_c ** 2).sum(-1) - scene.cyl_r ** 2)
        disc_c = b_xy * b_xy - a_xy * c_xy
        sq_c = torch.sqrt(torch.clamp_min(disc_c, 0.0))
        tc0 = (b_xy - sq_c) / a_xy
        tc1 = (b_xy + sq_c) / a_xy
        dz = safe_d[..., 2:3]
        tz_a = at(scene.cyl_z[..., 0]) / dz
        tz_b = at(scene.cyl_z[..., 1]) / dz
        tn_c = torch.maximum(tc0, torch.minimum(tz_a, tz_b))
        tf_c = torch.minimum(tc1, torch.maximum(tz_a, tz_b))
        hit_c = ((disc_c > 0) & (tn_c > eps) & (tn_c <= tf_c)
                 & (at(scene.cyl_on) > 0))
        t_cyl = [torch.where(hit_c, tn_c, big)]
    else:
        t_cyl = []  # obj then never indexes a cylinder slot

    # --- nearest object
    t_all = torch.cat([t_room[..., None], t_sph, t_box] + t_cyl, -1)
    obj = t_all.argmin(-1)
    t = t_all.amin(-1)
    p = d * t[..., None]                                   # hit point

    kind = torch.tensor([0] + [1] * MAX_SPHERES + [2] * MAX_BOXES
                        + [3] * MAX_CYLS, device=dev)[obj]

    # --- normals (inward-facing; all three types computed, then selected)
    n_room = -F.one_hot(face_ax, 3).to(f32) * torch.sign(safe_d)
    cyl_cen = torch.cat([scene.cyl_c, scene.cyl_z.mean(-1, keepdim=True)], -1)
    cyl_half = torch.stack(
        [scene.cyl_r, scene.cyl_r,
         torch.clamp_min((scene.cyl_z[..., 1] - scene.cyl_z[..., 0]) * 0.5,
                         1e-4)], -1)
    cen = torch.cat([torch.zeros(nb, 1, 3, dtype=f32, device=dev),
                     scene.sph_c, (scene.box_lo + scene.box_hi) * 0.5,
                     cyl_cen], 1)                          # (B, N_OBJ, 3)
    half = torch.cat([
        torch.ones(nb, 1, 3, dtype=f32, device=dev),
        scene.sph_r[..., None].expand(nb, MAX_SPHERES, 3),
        torch.clamp_min((scene.box_hi - scene.box_lo) * 0.5, 1e-4),
        cyl_half], 1)
    half_o = _take(half, obj)
    rel = p - _take(cen, obj)
    n_sphv = rel / torch.clamp_min(_norm(rel, True), 1e-9)
    q = rel / half_o
    box_ax = q.abs().argmax(-1)
    n_boxv = F.one_hot(box_ax, 3).to(f32) * torch.sign(_pick(q, box_ax))[
        ..., None]
    if v2:
        # cylinder: radial in xy on the side, +-z on the caps
        rel_xy = rel * torch.tensor([1.0, 1.0, 0.0], device=dev)
        n_side = rel_xy / torch.clamp_min(_norm(rel_xy, True), 1e-9)
        on_cap = rel[..., 2].abs() >= half_o[..., 2] * (1.0 - 1e-3)
        n_cap = torch.tensor([0.0, 0.0, 1.0], device=dev) \
            * torch.sign(rel[..., 2:3])
        n_cylv = torch.where(on_cap[..., None], n_cap, n_side)
        n_last = torch.where((kind == 2)[..., None], n_boxv, n_cylv)
    else:
        n_last = n_boxv
    n = torch.where((kind == 0)[..., None], n_room,
                    torch.where((kind == 1)[..., None], n_sphv, n_last))

    # --- procedural albedo (texture coordinates rotated about z in v2)
    if v2:
        rot = _take(scene.tex_rot, obj)
        cr, sr = torch.cos(rot), torch.sin(rot)
        pr = torch.stack([p[..., 0] * cr - p[..., 1] * sr,
                          p[..., 0] * sr + p[..., 1] * cr, p[..., 2]], -1)
    else:
        pr = p
    ps = pr * _take(scene.tex_scale, obj)[..., None]
    checker = (torch.floor(ps[..., 0]) + torch.floor(ps[..., 1])
               + torch.floor(ps[..., 2])) % 2.0
    stripes = 0.5 + 0.5 * torch.sin(
        ps[..., 0] * 2.3 + ps[..., 1] * 1.7 + ps[..., 2] * 0.9)
    marble = 0.5 + 0.5 * torch.sin(
        ps[..., 0] * 3.1 + 2.0 * torch.sin(ps[..., 1] * 2.2)
        + 1.3 * torch.sin(ps[..., 2] * 2.7))
    tk = _take(scene.tex_kind, obj)
    if v2:
        rings = 0.5 + 0.5 * torch.sin(
            6.0 * torch.sqrt(ps[..., 0] ** 2 + ps[..., 1] ** 2 + 1e-12))
        fr = ps - torch.floor(ps) - 0.5
        dots = ((fr * fr).sum(-1) < 0.09).to(f32)
        noise = 0.5 + 0.5 / 3.0 * (
            torch.sin(ps[..., 0] * 1.7 + ps[..., 1] * 2.3)
            + torch.sin(ps[..., 1] * 2.9 - ps[..., 2] * 1.1)
            + torch.sin(ps[..., 2] * 2.1 + ps[..., 0] * 3.3))
        tail = torch.where(tk == 3, marble,
                           torch.where(tk == 4, rings,
                                       torch.where(tk == 5, dots, noise)))
    else:
        tail = marble  # v1 draws tex_kind in 0..3 only
    m = torch.where(tk == 0, 0.0, torch.where(
        tk == 1, checker, torch.where(tk == 2, stripes, tail)))[..., None]
    room = (kind == 0)[..., None]
    wall = _take(scene.wall_color, face_id)
    c1 = torch.where(room, wall, _take(scene.obj_c1, obj))
    c2 = torch.where(room, wall * 0.55, _take(scene.obj_c2, obj))
    albedo = c1 * (1.0 - m) + c2 * m

    # --- headlight Lambertian shading with distance falloff
    lam = (n * d).sum(-1).abs()
    atten = 1.0 / (1.0 + (t / 7.0) ** 2)
    ambient = at(scene.ambient)
    shade = ambient + (1.0 - ambient) * lam * atten
    if v2:
        # point light (intensity 0 adds exactly 0): shadowless Lambertian
        lvec = at(scene.light_p) - p
        ldist = torch.clamp_min(_norm(lvec), 1e-6)
        lam2 = (n * lvec).sum(-1).abs() / ldist
        shade = shade + at(scene.light_i) * lam2 / (1.0 + (ldist / 4.0) ** 2)
    rgb = torch.clamp(albedo * shade[..., None], 0.0, 1.0)
    depth01 = torch.clamp(t * METERS_TO_01, 0.0, 1.0)
    return rgb, depth01


def render_pano(scene: Scene, width: int, height: int = None,
                v2: bool = True):
    """Equirect renders of the B scenes of ``scene`` (tensors) at (height,
    width), rays on the pipeline's x/(W-1) * 2pi grid: (rgb (B, H, W, 3),
    depth01 (B, H, W))."""
    height = height or width // 2
    dev = scene.room_lo.device
    azi = torch.arange(width, dtype=torch.float32, device=dev) \
        / (width - 1) * (2 * np.pi)
    zen = torch.arange(height, dtype=torch.float32, device=dev) \
        / (height - 1) * np.pi
    ag, zg = torch.meshgrid(azi, zen, indexing="xy")
    d = geometry.spherical_to_world(ag, zg, xp=torch)
    return _render_dirs(scene, d[None], v2)


def render_view(scene: Scene, fov, height: int, width: int,
                v2: bool = True):
    """Perspective renders through the gnomonic windows ``fov`` (B, 4)
    (stage-A ray geometry: pixel centres (i + 0.5) / n, reference
    Main.cpp:242-294): (rgb (B, H, W, 3), depth01 (B, H, W))."""
    win = geometry.make_window(fov[:, 0], fov[:, 1], fov[:, 2], fov[:, 3],
                               xp=torch)
    dev = fov.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        / height
    xg, yg = torch.meshgrid(xs, ys, indexing="xy")
    c = lambda v: v[:, None, None, :]
    pos = c(win.corner0) + c(win.hedge) * xg[..., None] \
        + c(win.vedge) * yg[..., None]
    d = pos / _norm(pos, True)
    return _render_dirs(scene, d, v2)


def sample_view_fov(rng: np.random.RandomState) -> np.ndarray:
    """Random viewing window in the production layouts' FOV regime
    (azimuth spans ~60-100 deg, zenith centers inside the valid band)."""
    fovx = rng.uniform(math.radians(60), math.radians(100))
    fovy = rng.uniform(math.radians(60), math.radians(100))
    azi_c = rng.uniform(0, 2 * math.pi)
    zen_c = rng.uniform(math.radians(45), math.radians(135))
    return np.array([azi_c - fovx / 2, azi_c + fovx / 2,
                     zen_c - fovy / 2, zen_c + fovy / 2], np.float32)


def _is_v2(version) -> bool:
    """False for v1 scenes only (their renders skip the v2 blocks)."""
    return version not in (1, "1", "v1")


def synth_batches(batch_size: int, kind: str = "perspective",
                  view_size: int = 256, pano_width: int = 512,
                  seed: int = 0, version=1, device="cuda"):
    """Infinite generator of training batches rendered on ``device``:
    ``(rgb (B, H, W, 3) f32, depth (B, H, W) f32, valid (B, H, W) bool)``,
    as ``panodepth.synth.synth_batches`` yields them.  Scene and window
    parameters are drawn on the host (tiny arrays), one batch ahead on a
    thread so that the device does not wait on the host's rejection
    loops."""
    from concurrent.futures import ThreadPoolExecutor

    from .pipeline import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    use_v2 = _is_v2(version)

    if kind == "perspective":
        def host_params():
            scenes = stack_scenes([sample_scene(rng, version)
                                   for _ in range(batch_size)])
            fovs = np.stack([sample_view_fov(rng)
                             for _ in range(batch_size)])
            return scenes, fovs

        def render(scenes, fovs):
            return render_view(scene_tensors(scenes, dev),
                               torch.from_numpy(fovs).to(dev), view_size,
                               view_size, use_v2)
    else:
        def host_params():
            return (stack_scenes([sample_scene(rng, version)
                                  for _ in range(batch_size)]),)

        def render(scenes):
            return render_pano(scene_tensors(scenes, dev), pano_width,
                               pano_width // 2, use_v2)

    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(host_params)
        while True:
            params = nxt.result()
            nxt = pool.submit(host_params)
            with torch.no_grad():
                rgb, dep = render(*params)
            yield rgb, dep, torch.ones_like(dep, dtype=torch.bool)


def write_dataset(outdir: str, count: int, width: int = 2048,
                  seed: int = 0, start: int = 0, version=1,
                  jpeg_quality: int = 95, noise_sigma: float = 0.0,
                  device="cuda", log=print) -> None:
    """Write ``count`` scenes as rgb/synth_NNNN.jpg + gt/synth_NNNN.png
    (matterport naming, consumable by the batch CLI), rendered on
    ``device``.  ``jpeg_quality`` / ``noise_sigma`` degrade the saved RGB
    only (gt stays exact); ``start`` burns that many scenes first, so that
    (seed, start) slices one stream into disjoint sets."""
    import os

    from . import io as pio
    from .pipeline import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    for _ in range(start):
        sample_scene(rng, version)
    os.makedirs(os.path.join(outdir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "gt"), exist_ok=True)
    use_v2 = _is_v2(version)
    for i in range(count):
        scene = stack_scenes([sample_scene(rng, version)])
        with torch.no_grad():
            rgb, dep = render_pano(scene_tensors(scene, dev), width, v2=use_v2)
        rgb, dep = rgb[0].cpu().numpy(), dep[0].cpu().numpy()
        name = f"synth_{start + i:04d}"
        if noise_sigma > 0.0:
            rgb = np.clip(rgb + rng.randn(*rgb.shape).astype(np.float32)
                          * noise_sigma, 0.0, 1.0)
        pio.save_jpg(os.path.join(outdir, "rgb", name + ".jpg"), rgb,
                     quality=jpeg_quality)
        pio.save_png16(os.path.join(outdir, "gt", name + ".png"),
                       (np.clip(dep, 0, 1) * 65535.0 + 0.5).astype(np.uint16))
        if (i + 1) % 10 == 0:
            log(f"[synth] {i + 1}/{count}")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="panodepth_torch.synth",
        description="write procedural scenes as rgb/ + gt/ folders")
    p.add_argument("count", type=int)
    p.add_argument("outdir")
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--start", type=int, default=0,
                   help="first scene index (for disjoint train/eval sets)")
    p.add_argument("--scenes", default="v1", choices=["v1", "v2", "mix"],
                   help="scene distribution: v1 = convex rooms, v2 = "
                        "diverse (L-rooms, corridors, cylinders, point "
                        "light), mix = 35%% v1 / 65%% v2")
    p.add_argument("--jpeg-quality", type=int, default=95,
                   help="JPEG quality for the saved RGB (gt stays exact)")
    p.add_argument("--noise-sigma", type=float, default=0.0,
                   help="Gaussian sensor noise added to the saved RGB "
                        "before JPEG encoding (gt stays exact)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    write_dataset(args.outdir, args.count, width=args.width, seed=args.seed,
                  start=args.start, version=args.scenes,
                  jpeg_quality=args.jpeg_quality,
                  noise_sigma=args.noise_sigma, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
