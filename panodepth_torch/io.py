"""Host-side image IO and dataset filename conventions.

Counterpart of ``panodepth/io.py`` without Pillow on the main path:

* 8/16-bit PNG load normalized to 0~1 floats (``EquirectangularMap::Load``
  / ``PerspectiveMap::Load``, Depth.cpp:45-109, 277-355) and 16-bit PNG
  save (``Save16BitPNG``, Depth.cpp:27-32), through a PNG codec written
  here with the standard library's ``zlib`` and numpy;
* PFM load with the vertical flip / minmax / 10 m cap of ``LoadPfm``
  (Depth.cpp:357-549);
* JPEG load through Pillow, imported only when a JPEG is read;
* the dataset filename conventions of the batch loop (Main.cpp:496-587).

The PNG codec reads non-interlaced 8- and 16-bit images of every colour
type but palette (grayscale, gray+alpha, RGB, RGBA), with all five row
filters, and writes 16-bit grayscale with the Up filter.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


# ---------------------------------------------------------------------------
# PNG codec


def _png_chunks(data: bytes, filename: str):
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{filename}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + length > len(data):
            break
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{filename}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{filename}: truncated PNG (no IEND)")


def _paeth_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter on one row of bytes (sequential along the row)."""
    out = bytearray(len(filt))
    p_row = prior.tobytes()
    f_row = filt.tobytes()
    for i in range(len(f_row)):
        a = out[i - bpp] if i >= bpp else 0
        b = p_row[i]
        c = p_row[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (f_row[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Average filter on one row of bytes."""
    out = bytearray(len(filt))
    p_row = prior.tobytes()
    f_row = filt.tobytes()
    for i in range(len(f_row)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (f_row[i] + ((a + p_row[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, f = kinds[y], filt[y]
        if kind == 0:      # None
            row = f
        elif kind == 1:    # Sub: a running sum per byte lane, mod 256
            row = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:    # Up
            row = f + prior
        elif kind == 3:    # Average
            row = _average_row(f, prior, bpp)
        elif kind == 4:    # Paeth
            row = _paeth_row(f, prior, bpp)
        else:
            raise ValueError(f"bad PNG row filter {kind}")
        out[y] = row
        prior = out[y]
    return out


def read_png(filename: str) -> np.ndarray:
    """Decode a PNG to uint8 or uint16, shape (H, W) or (H, W, C)."""
    with open(filename, "rb") as fp:
        data = fp.read()
    header, idat = None, []
    for kind, body in _png_chunks(data, filename):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{filename}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{filename}: unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); this reader takes "
            f"non-interlaced 8/16-bit gray, gray+alpha, RGB and RGBA")
    channels = _PNG_CHANNELS[colour]
    bpp = channels * depth // 8
    stride = width * bpp
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{filename}: corrupt PNG image data ({e})") from None
    if raw.size != height * (stride + 1):
        raise ValueError(f"{filename}: PNG image data has {raw.size} bytes, "
                         f"expected {height * (stride + 1)}")
    px = _unfilter(raw, height, stride, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(height, width, channels)
    return px[..., 0] if channels == 1 else px


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def save_png16(filename: str, data: np.ndarray, level: int = 1) -> None:
    """16-bit single-channel PNG (Save16BitPNG, Depth.cpp:27-32).

    Rows carry the Up filter (the first row's prior is zero, so it equals
    None there); ``level`` is the deflate level, always lossless.
    """
    arr = np.ascontiguousarray(data, np.uint16)
    if arr.ndim != 2:
        raise ValueError(f"save_png16 takes a 2-D array, got {arr.shape}")
    h, w = arr.shape
    rows = arr.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps mod 256, as the filter does
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(filename, "wb") as fp:
        fp.write(_PNG_SIG)
        fp.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)))
        fp.write(_png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), level)))
        fp.write(_png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# loading


def _read_with_pillow(filename: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"reading {filename} needs Pillow, which is not installed; "
            f"the PNG and PFM paths need no Pillow") from None
    with Image.open(filename) as img:
        return np.asarray(img)


def _to01(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype in (np.uint16, np.int32, np.uint32):
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def load_image01(filename: str, mono360: bool = False) -> np.ndarray:
    """Load an image as float32 0~1, shape (H, W) or (H, W, C).

    8-bit images divide by 255, 16-bit by 65535 (Depth.cpp:61-104).  ``.pfm``
    files follow EquirectangularMap::Load's dispatch (Depth.cpp:277-293):
    mono360 PFMs are flipped vertically and minmax-normalized, others are
    clamped at 0 and divided by 10 m.  PNGs decode here; other formats
    (JPEG) through Pillow.
    """
    low = filename.lower()
    if low.endswith(".pfm"):
        return load_pfm01(filename, flip_vertical=mono360, normalize=mono360)
    if low.endswith(".png"):
        return _to01(read_png(filename))
    return _to01(_read_with_pillow(filename))


def load_pfm(filename: str) -> np.ndarray:
    """Raw PFM float array, shape (H, W) or (H, W, 3), file row order kept.

    Mirrors load_pfm (Depth.cpp:376-453) including endianness handling.
    """
    with open(filename, "rb") as fp:
        header = fp.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"unsupported PFM type {header!r} in {filename}")
        dims = fp.readline().split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(fp.readline().strip())
        data = np.frombuffer(fp.read(width * height * channels * 4),
                             dtype="<f4" if scale < 0 else ">f4")
    data = data.astype(np.float32).reshape(height, width, channels)
    return data[..., 0] if channels == 1 else data


def load_pfm01(filename: str, flip_vertical: bool, normalize: bool) -> np.ndarray:
    """LoadPfm semantics (Depth.cpp:455-549): flip / normalize / 10 m cap."""
    img = load_pfm(filename)
    if flip_vertical:
        img = img[::-1]
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo)
    else:
        img = np.minimum(np.maximum(img, 0.0) / 10.0, 10.0)
    return np.ascontiguousarray(img, np.float32)


def to_uint16(img01: np.ndarray) -> np.ndarray:
    """C-cast quantization (ushort)(v * 65535) (Depth.cpp:1734)."""
    return (np.clip(img01, 0.0, 1.0) * 65535.0).astype(np.uint16)


# ---------------------------------------------------------------------------
# dataset filename conventions (reference Main.cpp:489-587)

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".pfm")


def list_images(folder: str) -> List[str]:
    """Sorted image files in a folder (AllFilesInFolder, Main.cpp:50-83)."""
    return [
        os.path.join(folder, f)
        for f in sorted(os.listdir(folder))
        if f.lower().endswith(IMAGE_EXTS)
    ]


def filter_files(files: List[str], include=None, exclude=None,
                 limit=None, shard=None) -> List[str]:
    """Runtime form of the reference's "only do some / skip certain cases"
    blocks (Main.cpp:357-407): substring match on the full path, include
    then exclude, then ``shard`` ("i/n": the round-robin slice
    ``files[i::n]``), then head-``limit`` (per shard)."""
    if include:
        files = [f for f in files if any(s in f for s in include)]
    if exclude:
        files = [f for f in files if not any(s in f for s in exclude)]
    if shard is not None:
        try:
            i, n = (int(x) for x in str(shard).split("/"))
        except ValueError:
            raise ValueError(f"shard must look like 'i/n', got {shard!r}")
        if not (n > 0 and 0 <= i < n):
            raise ValueError(f"shard index out of range: {shard!r}")
        files = files[i::n]
    if limit is not None:
        files = files[:limit]
    return files


def raw_name(path: str) -> str:
    """Filename without directory and final extension (Main.cpp:452-454)."""
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base if dot < 0 else base[:dot]


def baseline_filename(baseline_folder: str, rawname: str,
                      result_folder: str) -> str:
    """Per-method baseline naming (Main.cpp:500-516), inferred from the
    result folder's name: slicenet -> ``.jpg.slicenet.png``, unifuse ->
    ``.unifuse.jpg``, hohonet -> ``.depth.png``, default (bifuse) -> ``.jpg``.
    """
    rf = result_folder.lower()
    if "slicenet" in rf:
        suffix = ".jpg.slicenet.png"
    elif "unifuse" in rf:
        suffix = ".unifuse.jpg"
    elif "hohonet" in rf:
        suffix = ".depth.png"
    else:
        suffix = ".jpg"
    return os.path.join(baseline_folder, rawname + suffix)


def gt_filename(gt_folder: str, rawname: str, dataset: str = "matterport") -> str:
    """Ground-truth naming per dataset (Main.cpp:517-549)."""
    if dataset == "replica":
        return os.path.join(gt_folder, rawname.replace("rgb", "depth") + ".pfm")
    if dataset == "suncg":
        return os.path.join(
            gt_folder, (rawname + ".exr.png").replace("_color", "_depth")
        )
    # matterport default; stanford2d3d additionally swaps _rgb -> _depth
    name = (rawname + ".png").replace("_rgb", "_depth")
    return os.path.join(gt_folder, name)


def pmap_filenames(views_folder: str, rawname: str, layout,
                   ext: str = ".jpg") -> List[str]:
    """Perspective map filenames ``<raw>.<aziL>_<aziR>_<zenT>_<zenD><ext>``
    (Main.cpp:569-587, SaveCubeMap Main.cpp:313-315)."""
    return [
        os.path.join(views_folder, f"{rawname}.{layout.view_tag(i)}{ext}")
        for i in range(layout.num_views)
    ]
