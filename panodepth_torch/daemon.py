"""Persistent HTTP serving daemon for exported artifacts.

Counterpart of ``panodepth/daemon.py``.  The reference's deployment is a
batch binary re-run per dataset (reference ``Main.cpp:489-685``: full
GL/shader/Ceres start-up on every invocation).  :mod:`panodepth_torch.serve`
replaces the binary with an exported program; this module is the
long-running process around it: load the artifact once, keep it resident
on the card (one CUDA graph per input shape), and serve many requests.

Dynamic micro-batching: an artifact's shapes are static, so its leading
axis is a fixed batch ``B``.  Single-item requests are coalesced into one
device call, up to ``B`` items, waiting at most ``--max-delay-ms`` after
the first arrival, and the results fan back out to their callers.
Short-fill batches are padded by repeating the first item (padding rows
are computed and discarded; each panorama's output does not depend on its
batch, so this only wastes work).  A single runner thread owns the card:
it stacks the items on the host, copies them to the card, runs the
artifact (its first call captures the graph) and copies the outputs back.
HTTP handler threads decode and encode on the host, enqueue and wait; they
make no CUDA call.

Protocol (standard library only):

    GET  /healthz   -> {"status": "ok", ...}          liveness + artifact kind
    GET  /describe  -> the artifact's meta sidecar as JSON
    GET  /stats     -> request/batch counters, batch fill, latency quantiles
    POST /infer     body = ``.npz`` with arrays ``in0..inN`` (ONE item each,
                    no batch dim) -> ``.npz`` with arrays ``out0..outN``
    POST /infer     body = JPEG/PNG/BMP bytes (``Content-Type: image/*``),
                    e2e artifacts only -> 16-bit PNG depth panorama

Images are decoded by the port's own codecs (``io.decode_image``: the JPEG
codec ``csrc/jpeg.cpp``, the PNG and BMP readers of ``io.py``); an image
they refuse (a progressive or arithmetic-coded JPEG, CMYK, 16-bit) is a
400 with the codec's message.  Responses are written by ``io.png_bytes``
at ``io.png_level()``, the level the result files get
(``PANODEPTH_PNG_LEVEL``, default 1).

Run:  ``python -m panodepth_torch.serve daemon ART.pt2 --port 8765``
"""

from __future__ import annotations

import io as _io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import io as pio


class Overloaded(RuntimeError):
    """Queue full: the daemon sheds load instead of buffering unboundedly."""


class _Pending:
    __slots__ = ("arrays", "event", "result", "error", "abandoned")

    def __init__(self, arrays):
        self.arrays = arrays
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False  # caller timed out; don't compute for it


class Batcher:
    """Coalesce single-item requests into fixed-size device calls."""

    def __init__(self, artifact, max_delay_ms: float = 5.0,
                 max_queue: int = 0):
        self.artifact = artifact
        self.batch = int(artifact.meta["in_shapes"][0][0])
        self.item_shapes = [tuple(s[1:]) for s in artifact.meta["in_shapes"]]
        self.item_dtypes = [np.dtype(d) for d in artifact.meta["in_dtypes"]]
        self.max_delay = max_delay_ms / 1000.0
        # backpressure: beyond a few batches of queued work, reject
        # instead of buffering (latency there is already hopeless)
        self._q: queue.Queue = queue.Queue(
            maxsize=max_queue or 8 * self.batch)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats = dict(requests=0, batches=0, items=0, errors=0,
                          timeouts=0, rejected=0, bad_requests=0)
        self._latencies: list = []  # seconds, per item, capped window
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="panodepth-batch-runner")

    # -- client side -----------------------------------------------------
    def validate(self, arrays):
        if len(arrays) != len(self.item_shapes):
            raise ValueError(f"expected {len(self.item_shapes)} input "
                             f"arrays, got {len(arrays)}")
        for k, (a, shape, dt) in enumerate(
                zip(arrays, self.item_shapes, self.item_dtypes)):
            if tuple(a.shape) != shape:
                raise ValueError(f"in{k}: expected shape {shape}, "
                                 f"got {tuple(a.shape)}")
            if a.dtype != dt:
                raise ValueError(f"in{k}: expected dtype {dt}, got {a.dtype}")

    def submit(self, arrays, timeout: float = 120.0):
        """Enqueue one item; block until its batch ran; return outputs."""
        try:
            self.validate(arrays)
        except ValueError:
            with self._lock:
                self.stats["bad_requests"] += 1
            raise
        p = _Pending(arrays)
        t0 = time.monotonic()
        with self._lock:
            self.stats["requests"] += 1
        try:
            self._q.put_nowait(p)
        except queue.Full:
            with self._lock:
                self.stats["rejected"] += 1
            raise Overloaded(
                f"queue full ({self._q.maxsize} items); retry later")
        if not p.event.wait(timeout):
            # the runner skips abandoned items: a timed-out request must
            # not burn device batches computing results nobody reads
            p.abandoned = True
            with self._lock:
                self.stats["timeouts"] += 1
            raise TimeoutError("inference timed out")
        with self._lock:
            self._latencies.append(time.monotonic() - t0)
            if len(self._latencies) > 10000:
                del self._latencies[:5000]
        if p.error is not None:
            raise p.error
        return p.result

    # -- device side -----------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.monotonic() + self.max_delay
            while len(items) < self.batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            # drop items whose caller already timed out (an abandonment
            # after this point only wastes that item's row, never a batch)
            items = [it for it in items if not it.abandoned]
            if not items:
                continue
            try:
                pad = self.batch - len(items)
                stacked = [
                    np.stack([it.arrays[k] for it in items]
                             + [items[0].arrays[k]] * pad)
                    for k in range(len(self.item_shapes))
                ]
                outs = self.artifact(*stacked)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                # the copies back wait for the device
                outs = [np.asarray(o.cpu()) if hasattr(o, "cpu")
                        else np.asarray(o) for o in outs]
                for i, it in enumerate(items):
                    it.result = tuple(o[i] for o in outs)
                    it.event.set()
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["items"] += len(items)
            except Exception as e:  # noqa: BLE001 — fan the error out
                # one server-side line per failed batch: operators must
                # see device failures even though per-request HTTP
                # logging is off
                print(f"[daemon] batch of {len(items)} FAILED: "
                      f"{type(e).__name__}: {e}", flush=True)
                with self._lock:
                    self.stats["errors"] += len(items)
                for it in items:
                    it.error = e
                    it.event.set()

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def snapshot(self):
        with self._lock:
            s = dict(self.stats)
            lat = sorted(self._latencies)
        s["mean_batch_fill"] = (s["items"] / s["batches"]
                                if s["batches"] else 0.0)
        if lat:
            s["latency_ms_p50"] = round(lat[len(lat) // 2] * 1000, 2)
            s["latency_ms_p99"] = round(lat[(len(lat) * 99) // 100
                                            if len(lat) > 1 else 0]
                                        * 1000, 2)
        return s


def decode_image_rgb(body: bytes) -> np.ndarray:
    """An 8-bit image body as (H, W, 3) uint8 RGB: gray replicated, alpha
    dropped (Pillow's ``convert("RGB")``).  Raises ValueError for what the
    port's codecs refuse and for 16-bit images."""
    px = pio.decode_image(body, "request body")
    if px.dtype != np.uint8:
        raise ValueError(f"request body: a {px.dtype.itemsize * 8}-bit "
                         f"image; send 8-bit RGB")
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[2] in (1, 2):  # gray, gray + alpha
        px = np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def encode_png16(u16: np.ndarray) -> bytes:
    """A 16-bit PNG of ``u16`` at ``io.png_level()``, as ``io.save_png16``
    writes a result file."""
    return pio.png_bytes(np.ascontiguousarray(u16, np.uint16),
                         pio.png_level())


# request bodies are one image / one item's arrays — cap them so a bogus
# Content-Length cannot allocate unboundedly
MAX_BODY_BYTES = 256 * 1024 * 1024


def make_handler(batcher: Batcher, meta: dict):
    kind = meta.get("kind", "unknown")

    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the daemon prints its own line per batch-error
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "kind": kind,
                                 "batch": batcher.batch})
            elif self.path == "/describe":
                self._json(200, meta)
            elif self.path == "/stats":
                self._json(200, batcher.snapshot())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/infer":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._json(413, {"error": f"body {n} bytes exceeds "
                                              f"{MAX_BODY_BYTES}"})
                    return
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("image/"):
                    self._infer_image(body)
                else:
                    self._infer_npz(body)
            except (ValueError, KeyError) as e:
                self._json(400, {"error": str(e)})
            except Overloaded as e:
                self._json(503, {"error": str(e)})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _infer_npz(self, body: bytes) -> None:
            with np.load(_io.BytesIO(body)) as z:
                arrays = [z[f"in{k}"]
                          for k in range(len(batcher.item_shapes))]
            outs = batcher.submit(arrays)
            buf = _io.BytesIO()
            np.savez(buf, **{f"out{k}": o for k, o in enumerate(outs)})
            self._bytes(200, buf.getvalue(), "application/npz")

        def _infer_image(self, body: bytes) -> None:
            if len(batcher.item_shapes) != 1 or \
                    len(batcher.item_shapes[0]) != 3:
                raise ValueError(
                    "image body only supported for single-input e2e "
                    f"artifacts (this one is '{kind}' with inputs "
                    f"{batcher.item_shapes}); POST an .npz instead")
            rgb = decode_image_rgb(body)
            want = batcher.item_shapes[0]
            if rgb.shape != want:
                raise ValueError(f"image is {rgb.shape}, artifact expects "
                                 f"{want}")
            outs = batcher.submit([rgb])
            depth = outs[0]
            if depth.dtype != np.uint16:
                depth = pio.to_uint16(depth.astype(np.float32))
            self._bytes(200, encode_png16(depth), "image/png")

    return Handler


class Daemon:
    """Bind + serve; usable programmatically (tests) or via the CLI."""

    def __init__(self, artifact, host: str = "127.0.0.1", port: int = 0,
                 max_delay_ms: float = 5.0, warmup: bool = True):
        self.artifact = artifact
        self.batcher = Batcher(artifact, max_delay_ms=max_delay_ms)
        self.batcher.start()
        if warmup:
            # the runner's first call captures the graph of the batch shape
            self.batcher.submit([np.zeros(s, d) for s, d in zip(
                self.batcher.item_shapes, self.batcher.item_dtypes)])
            # it counts as a request, but its capture is no served
            # request's latency
            with self.batcher._lock:
                self.batcher._latencies.clear()
        self.server = ThreadingHTTPServer(
            (host, port), make_handler(self.batcher, artifact.meta))
        self.server.daemon_threads = True

    @property
    def address(self):
        return self.server.server_address

    def serve_forever(self):
        self.server.serve_forever()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.stop()


def run_daemon(artifact_path: str, host: str, port: int,
               max_delay_ms: float, warmup: bool = True, log=print,
               device=None) -> int:
    from . import serve

    art = serve.load(artifact_path, device)
    log(f"[daemon] loading {artifact_path}: {art.describe()}")
    t0 = time.monotonic()
    d = Daemon(art, host=host, port=port, max_delay_ms=max_delay_ms,
               warmup=warmup)
    log(f"[daemon] ready in {time.monotonic() - t0:.1f}s — serving on "
        f"http://{d.address[0]}:{d.address[1]} (batch {d.batcher.batch}, "
        f"max-delay {max_delay_ms:.0f} ms)")
    try:
        d.serve_forever()
    except KeyboardInterrupt:
        log("[daemon] shutting down")
    finally:
        d.stop()
    return 0
