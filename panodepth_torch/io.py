"""Host-side image IO and dataset filename conventions.

Counterpart of ``panodepth/io.py`` with codecs of the port's own, no
Pillow anywhere:

* PNG, JPEG and BMP load normalized to 0~1 floats
  (``EquirectangularMap::Load`` / ``PerspectiveMap::Load``,
  Depth.cpp:45-109, 277-355), or as their integers (``load_image_int``);
* 16-bit PNG save (``Save16BitPNG``, Depth.cpp:27-32), 8-bit PNG save
  (``Save8bit``, Depth.cpp:612-635) and the stage-A JPEG save
  (Main.cpp:320);
* PFM load with the vertical flip / minmax / 10 m cap of ``LoadPfm``
  (Depth.cpp:357-549), and PFM save;
* the dataset filename conventions of the batch loop (Main.cpp:496-587).

PNGs are read and written by the port's native codec
(``utils/nativeio.py`` over ``csrc/pngio.cpp``, host C++ built at first
use): it reads non-interlaced 8- and 16-bit images of every colour type but
palette (grayscale, gray+alpha, RGB, RGBA), with all five row filters, and
writes 8-bit gray or RGB and 16-bit gray with the Up filter.  The same
codec written with the standard library's ``zlib`` and numpy stays here as
its plain twin (``read_png_py``, ``png_bytes_py``), which the tests hold
the native one to and no path of the port calls.  JPEG goes through
``panodepth_torch.jpeg`` (host C++ built at first use), which gives the
pixels Pillow gives.  The BMP reader takes uncompressed 8-bit gray
(a palette of grays) and 24/32-bit BGR[A], bottom-up and top-down.  Files
are told apart by their first bytes, as Pillow does; ``.pfm`` by its name,
as the JAX package does.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

import numpy as np

from . import jpeg
from .utils import nativeio

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
    """Undo the row filters.  A run of Up rows is one cumulative sum down
    the run (mod 256) on the row before it, and a run of None rows a copy:
    whole-array numpy calls, which leave the GIL to other decoding
    threads; Sub, Average and Paeth go row by row."""
    rows = raw.reshape(height, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"bad PNG row filter {int(kinds.max())}")
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    # the first row of each run of one filter kind
    starts = np.flatnonzero(np.diff(kinds, prepend=-1)).tolist() + [height]
    for y0, y1 in zip(starts[:-1], starts[1:]):
        kind, f = kinds[y0], filt[y0:y1]
        if kind == 0:      # None
            out[y0:y1] = f
        elif kind == 2:    # Up: each row plus the one above, mod 256
            np.cumsum(f, axis=0, dtype=np.uint8, out=out[y0:y1])
            out[y0:y1] += prior
        else:
            for y in range(y0, y1):
                if kind == 1:    # Sub: a running sum per byte lane, mod 256
                    row = np.cumsum(filt[y].reshape(-1, bpp), axis=0,
                                    dtype=np.uint8).reshape(-1)
                elif kind == 3:  # Average
                    row = _average_row(filt[y], prior, bpp)
                else:            # Paeth
                    row = _paeth_row(filt[y], prior, bpp)
                out[y] = row
                prior = out[y]
        prior = out[y1 - 1]
    return out


def read_png(filename: str, data: Optional[bytes] = None) -> np.ndarray:
    """Decode a PNG (the file, or its bytes ``data``) to uint8 or uint16,
    shape (H, W) or (H, W, C), with the native codec; errors name
    ``filename``."""
    return nativeio.decode_png(filename if data is None else data, filename)


def read_png_py(filename: str, data: Optional[bytes] = None) -> np.ndarray:
    """:func:`read_png` in Python (zlib and numpy): the native decoder's
    plain twin."""
    if data is None:
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


def png_bytes(arr: np.ndarray, level: int) -> bytes:
    """A uint8 or uint16 gray (H, W) or RGB (H, W, 3) PNG, encoded by the
    native codec.  Rows carry the Up filter (the first row's prior is zero,
    so it equals None there); ``level`` is the deflate level, always
    lossless."""
    return nativeio.encode_png(arr, level)


def png_bytes_py(arr: np.ndarray, level: int) -> bytes:
    """:func:`png_bytes` in Python (zlib and numpy): the native encoder's
    plain twin, the same bytes where both run one zlib."""
    h, w = arr.shape[:2]
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    rows = arr.astype(">u2" if depth == 16 else np.uint8).view(np.uint8)
    rows = rows.reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps mod 256, as the filter does
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    colour = 0 if channels == 1 else 2
    return b"".join((
        _PNG_SIG,
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                        0, 0)),
        _png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), level)),
        _png_chunk(b"IEND", b"")))


def _write_png(filename: str, arr: np.ndarray, level: int) -> None:
    """:func:`png_bytes` written to ``filename`` (by the native codec)."""
    nativeio.write_png(filename, arr, level)


def png_level() -> int:
    """The deflate level of the 16-bit result PNGs: ``PANODEPTH_PNG_LEVEL``
    (the CLI's ``--png-level`` sets it), else 1, the fastest to write."""
    return int(os.environ.get("PANODEPTH_PNG_LEVEL", "1"))


def save_png16(filename: str, data: np.ndarray, level: int = None) -> None:
    """16-bit single-channel PNG (Save16BitPNG, Depth.cpp:27-32);
    ``level`` is the deflate level (always lossless), :func:`png_level`
    when None."""
    nativeio.write_png16(filename, data,
                         png_level() if level is None else level)


def _to_u8(img01: np.ndarray) -> np.ndarray:
    """0~1 floats -> uint8 by truncation, as the JAX package's savers do."""
    return (np.clip(img01, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_png8(filename: str, img01: np.ndarray) -> None:
    """8-bit gray PNG of a 0~1 float map (Save8bit, Depth.cpp:612-635)."""
    arr = _to_u8(img01)
    if arr.ndim != 2:
        raise ValueError(f"save_png8 takes a 2-D array, got {arr.shape}")
    _write_png(filename, arr, 6)


def save_jpg(filename: str, img01: np.ndarray, quality: int = 95) -> None:
    """JPEG of a 0~1 float image (stage-A view export, Main.cpp:320).

    2-D input saves as 8-bit grayscale, (H, W, 3) as RGB.  As with
    Pillow's save, the format follows the name: ``.png`` writes an 8-bit
    PNG of the same pixels instead.
    """
    arr = _to_u8(img01)
    low = filename.lower()
    if low.endswith(".png"):
        _write_png(filename, np.ascontiguousarray(arr), 6)
        return
    if not low.endswith((".jpg", ".jpeg")):
        raise ValueError(f"{filename}: save_jpg writes .jpg, .jpeg or .png")
    data = jpeg.encode(arr, quality)
    with open(filename, "wb") as fp:
        fp.write(data)


def save_pfm(filename: str, img: np.ndarray) -> None:
    """Write a little-endian PFM (Pf/PF)."""
    img = np.asarray(img, np.float32)
    channels = 1 if img.ndim == 2 else img.shape[2]
    with open(filename, "wb") as fp:
        fp.write(b"PF\n" if channels == 3 else b"Pf\n")
        fp.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        fp.write(b"-1.0\n")
        fp.write(img.astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# BMP reader


def _read_bmp(data: bytes, filename: str) -> np.ndarray:
    """Uncompressed 8-bit gray (palette of grays), 24-bit BGR and 32-bit
    BGRX / BGRA BMPs -> uint8 (H, W), (H, W, 3) or (H, W, 4), as Pillow
    reads them (32-bit BI_RGB drops the fourth byte)."""
    def u32(off):
        return struct.unpack_from("<I", data, off)[0]

    if len(data) < 54:
        raise ValueError(f"{filename}: truncated BMP")
    offset, header = u32(10), u32(14)
    if header < 40:
        raise ValueError(f"{filename}: BMP core header ({header} bytes) is "
                         f"not supported")
    if len(data) < 14 + header + 12:  # the header and any bit fields
        raise ValueError(f"{filename}: truncated BMP")
    width, height = struct.unpack_from("<ii", data, 18)
    bpp, = struct.unpack_from("<H", data, 28)
    compression, colours = u32(30), u32(46)
    top_down = height < 0
    height = abs(height)
    if width <= 0 or height == 0:
        raise ValueError(f"{filename}: bad BMP size {width}x{height}")
    if bpp == 8 and compression == 0:
        colours = colours or 256
        if colours > 256:
            raise ValueError(f"{filename}: 8-bit BMP with {colours} colours")
        pal = np.frombuffer(data, np.uint8, 4 * colours, 14 + header)
        pal = pal.reshape(colours, 4)[:, :3]
        if not np.array_equal(pal, np.repeat(np.arange(colours, dtype=np.uint8)
                                             [:, None], 3, axis=1)):
            raise ValueError(f"{filename}: 8-bit BMP with a colour palette "
                             f"is not supported (gray palettes only)")
        channels, order = 1, [0]
    elif bpp == 24 and compression == 0:
        channels, order = 3, [2, 1, 0]
    elif bpp == 32 and compression == 0:
        channels, order = 4, [2, 1, 0]
    elif bpp == 32 and compression == 3:
        masks_at = 14 + 40 if header >= 52 else 14 + header
        masks = struct.unpack_from("<III", data, masks_at)
        alpha = u32(14 + 52) if header >= 56 else 0
        if masks != (0xFF0000, 0xFF00, 0xFF) or alpha not in (0, 0xFF000000):
            raise ValueError(f"{filename}: BMP bit fields {masks} are not "
                             f"supported")
        channels, order = 4, [2, 1, 0, 3] if alpha else [2, 1, 0]
    else:
        raise ValueError(f"{filename}: {bpp}-bit BMP with compression "
                         f"{compression} is not supported")
    stride = (width * bpp // 8 + 3) // 4 * 4
    if offset + stride * height > len(data):
        raise ValueError(f"{filename}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * height, offset)
    px = rows.reshape(height, stride)[:, :width * channels]
    px = px.reshape(height, width, channels)[:, :, order]
    if not top_down:
        px = px[::-1]
    px = np.ascontiguousarray(px)
    return px[..., 0] if channels == 1 else px


# ---------------------------------------------------------------------------
# loading


def read_image(filename: str) -> np.ndarray:
    """A PNG, JPEG or BMP file's pixels, uint8 or uint16, (H, W) or
    (H, W, C); the format is told by the first bytes, as Pillow does."""
    with open(filename, "rb") as fp:
        return decode_image(fp.read(), filename)


def decode_image(data: bytes, name: str) -> np.ndarray:
    """:func:`read_image` of a file's bytes; errors name ``name``."""
    if data[:8] == _PNG_SIG:
        return read_png(name, data)
    if data[:2] == b"\xff\xd8":
        return jpeg.decode(data, name)
    if data[:2] == b"BM":
        return _read_bmp(data, name)
    raise ValueError(f"{name}: not a PNG, JPEG or BMP file")


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
    clamped at 0 and divided by 10 m.  PNG, JPEG and BMP decode through
    the port's own codecs (:func:`read_image`).
    """
    if filename.lower().endswith(".pfm"):
        return load_pfm01(filename, flip_vertical=mono360, normalize=mono360)
    return _to01(read_image(filename))


def load_image_int(filename: str):
    """Integer-preserving load: (array, scale), or ``None`` for PFM floats.

    The decoded uint8 or uint16 array with its 0~1 normalization divisor
    (255.0 / 65535.0); ``array / scale`` equals :func:`load_image01` up to
    1 f32 ulp.
    """
    if filename.lower().endswith(".pfm"):
        return None
    arr = read_image(filename)
    return arr, (255.0 if arr.dtype == np.uint8 else 65535.0)


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
