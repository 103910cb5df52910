"""The port's serving daemon (``panodepth_torch.daemon``): the HTTP surface,
micro-batching and error paths of tests/test_daemon.py, over artifacts the
port exported on the CPU, driven over real HTTP on a loopback socket.

The merge daemon serves tests/test_daemon.py's artifact (3fold, out 256,
u16 64x128 baselines and 96x128 views, batch 4); the e2e daemon the zoo's
NF perspective net and FastPanoNet (bf16, as shipped; baseline 128 wide,
views 32, u8 64x128 RGB, batch 2).  Images go in as the port's own JPEG
and PNG bytes and every returned PNG is held bit-equal to the artifact's
direct output; a JPEG the port's codec refuses is a 400 carrying its
message.
"""

import hashlib
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from panodepth_torch import daemon as tdaemon
from panodepth_torch import io as tio
from panodepth_torch import jpeg
from panodepth_torch import serve as tserve
from panodepth_torch.config import MergeConfig
from panodepth_torch.daemon import Batcher, Daemon, Overloaded

from torch_port_common import zoo_pair

torch.set_num_threads(1)


def _serve(art, max_delay_ms, warmup=True):
    d = Daemon(art, port=0, max_delay_ms=max_delay_ms, warmup=warmup)
    t = threading.Thread(target=d.serve_forever, daemon=True)
    t.start()
    return d, t


@pytest.fixture(scope="module")
def daemon_art(tmp_path_factory):
    cfg = MergeConfig(out_width=256, layout_name="3fold")
    path = str(tmp_path_factory.mktemp("art") / "merge.pt2")
    tserve.export_merge(path, cfg, batch=4, emap_shape=(64, 128),
                        pmap_shape=(96, 128), dtype="uint16", device="cpu")
    art = tserve.load(path)
    d, t = _serve(art, 30.0)
    yield d, art, cfg
    d.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _url(d, path):
    host, port = d.address
    return f"http://{host}:{port}{path}"


def _post_npz(d, arrays, timeout=120):
    buf = io.BytesIO()
    np.savez(buf, **{f"in{k}": a for k, a in enumerate(arrays)})
    req = urllib.request.Request(_url(d, "/infer"), data=buf.getvalue(),
                                 headers={"Content-Type": "application/npz"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "application/npz"
        return dict(np.load(io.BytesIO(r.read())))


def _post_image(d, body, ctype="image/jpeg", timeout=120):
    req = urllib.request.Request(_url(d, "/infer"), data=body,
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=timeout)


def _http_error(req, timeout=60):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=timeout)
    return ei.value.code, json.loads(ei.value.read())


def test_health_and_describe(daemon_art):
    d, art, _ = daemon_art
    with urllib.request.urlopen(_url(d, "/healthz"), timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["kind"] == "merge" and h["batch"] == 4
    with urllib.request.urlopen(_url(d, "/describe"), timeout=30) as r:
        meta = json.loads(r.read())
    assert meta == art.meta


def test_concurrent_requests_match_direct_batch(daemon_art):
    """N concurrent single-item posts == the direct artifact call."""
    d, art, cfg = daemon_art
    rng = np.random.RandomState(1)
    v = cfg.layout.num_views
    n = 5  # more than one batch's worth arrives inside the delay window
    emaps = rng.randint(0, 65536, (n, 64, 128)).astype(np.uint16)
    pmaps = rng.randint(0, 65536, (n, v, 96, 128)).astype(np.uint16)

    results = [None] * n
    errs = []

    def worker(i):
        try:
            results[i] = _post_npz(d, [emaps[i], pmaps[i]])
        except Exception as e:  # pragma: no cover - surfaced by assert
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in threads)

    # direct calls at full batch for the oracle (padded with item n-1)
    outs, abcds = [], []
    for c in range(0, n, 4):
        idx = [min(i, n - 1) for i in range(c, c + 4)]
        o, a = art(emaps[idx], pmaps[idx])
        outs.append(o.numpy())
        abcds.append(a.numpy())
    out_ref = np.concatenate(outs)[:n]
    abcd_ref = np.concatenate(abcds)[:n]
    for i in range(n):
        # each panorama's bits do not depend on its batch
        np.testing.assert_array_equal(results[i]["out0"], out_ref[i])
        np.testing.assert_array_equal(results[i]["out1"], abcd_ref[i])


def test_stats_counts_and_fill(daemon_art):
    d, _, _ = daemon_art
    with urllib.request.urlopen(_url(d, "/stats"), timeout=30) as r:
        s = json.loads(r.read())
    # warmup + at least the 5 concurrent requests above
    assert s["requests"] >= 6
    assert s["batches"] >= 2
    assert 1.0 <= s["mean_batch_fill"] <= 4.0
    assert s["latency_ms_p50"] > 0
    assert set(s) == {"requests", "batches", "items", "errors", "timeouts",
                      "rejected", "bad_requests", "mean_batch_fill",
                      "latency_ms_p50", "latency_ms_p99"}


def test_bad_shape_is_400_not_crash(daemon_art):
    d, _, cfg = daemon_art
    v = cfg.layout.num_views
    bad = [np.zeros((32, 64), np.uint16),  # wrong emap shape
           np.zeros((v, 96, 128), np.uint16)]
    buf = io.BytesIO()
    np.savez(buf, **{f"in{k}": a for k, a in enumerate(bad)})
    code, body = _http_error(urllib.request.Request(
        _url(d, "/infer"), data=buf.getvalue()))
    assert code == 400 and "expected shape" in body["error"]
    # daemon still alive
    with urllib.request.urlopen(_url(d, "/healthz"), timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"


def test_wrong_dtype_and_missing_array_400(daemon_art):
    d, _, cfg = daemon_art
    v = cfg.layout.num_views
    # f32 where u16 expected
    bad = [np.zeros((64, 128), np.float32),
           np.zeros((v, 96, 128), np.uint16)]
    buf = io.BytesIO()
    np.savez(buf, **{f"in{k}": a for k, a in enumerate(bad)})
    code, _ = _http_error(urllib.request.Request(_url(d, "/infer"),
                                                 data=buf.getvalue()))
    assert code == 400
    # npz missing in1 entirely
    buf = io.BytesIO()
    np.savez(buf, in0=np.zeros((64, 128), np.uint16))
    code, _ = _http_error(urllib.request.Request(_url(d, "/infer"),
                                                 data=buf.getvalue()))
    assert code == 400


def test_image_body_rejected_for_merge_artifact(daemon_art):
    """merge artifacts take 2 inputs; an image body must 400 with advice."""
    d, _, _ = daemon_art
    body = jpeg.encode(np.zeros((64, 128, 3), np.uint8))
    code, err = _http_error(urllib.request.Request(
        _url(d, "/infer"), data=body, headers={"Content-Type": "image/jpeg"}))
    assert code == 400 and "npz" in err["error"]


def test_unknown_route_404(daemon_art):
    d, _, _ = daemon_art
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(d, "/nope"), timeout=30)
    assert ei.value.code == 404
    code, _ = _http_error(urllib.request.Request(_url(d, "/other"),
                                                 data=b"x"))
    assert code == 404


def test_body_size_cap_413(daemon_art, monkeypatch):
    d, _, _ = daemon_art
    monkeypatch.setattr(tdaemon, "MAX_BODY_BYTES", 1024)
    code, _ = _http_error(urllib.request.Request(_url(d, "/infer"),
                                                 data=b"x" * 2048))
    assert code == 413


class _StubArtifact:
    """Minimal artifact double for Batcher unit tests (no device)."""

    meta = dict(in_shapes=[[2, 4]], in_dtypes=["float32"], kind="stub")

    def __init__(self, fail=False):
        self.calls = 0
        self.fail = fail

    def __call__(self, x):
        self.calls += 1
        if self.fail:
            raise RuntimeError("device fault")
        return (torch.from_numpy(np.asarray(x) * 2.0),)


def test_batcher_timeout_abandons_item():
    """A timed-out request is skipped by the runner (no dead device work)
    and counted in the timeout stats, not in errors/latencies."""
    art = _StubArtifact()
    b = Batcher(art, max_delay_ms=1.0)  # not started yet
    with pytest.raises(TimeoutError):
        b.submit([np.zeros((4,), np.float32)], timeout=0.05)
    assert b.stats["timeouts"] == 1 and b.stats["errors"] == 0
    b.start()
    out, = b.submit([np.ones((4,), np.float32)], timeout=30)
    np.testing.assert_array_equal(out, np.full((4,), 2.0, np.float32))
    # only the live item was computed; the abandoned one was dropped
    assert b.stats["items"] == 1 and art.calls == 1
    b.stop()


def test_warmup_is_not_a_latency_sample():
    """The start-up call counts as a request and a batch, but its capture
    is kept out of the latency quantiles: they cover served requests."""
    d = Daemon(_StubArtifact(), port=0, max_delay_ms=1.0)
    try:
        s = d.batcher.snapshot()
        assert s["requests"] == s["batches"] == s["items"] == 1
        assert "latency_ms_p50" not in s
        d.batcher.submit([np.ones((4,), np.float32)], timeout=30)
        assert d.batcher.snapshot()["latency_ms_p50"] >= 0
        assert len(d.batcher._latencies) == 1
    finally:
        d.server.server_close()
        d.batcher.stop()


def test_batcher_backpressure_rejects():
    """Beyond the queue bound, submits shed load with Overloaded (503)
    instead of buffering unboundedly."""
    art = _StubArtifact()
    b = Batcher(art, max_queue=2)  # runner never started: queue only fills
    errs = []

    def blocked():
        try:
            b.submit([np.zeros((4,), np.float32)], timeout=1.0)
        except TimeoutError:
            pass
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=blocked) for _ in range(2)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    while b._q.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(Overloaded):
        b.submit([np.zeros((4,), np.float32)], timeout=1.0)
    assert b.stats["rejected"] == 1
    for t in ts:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in ts)
    assert b.stats["bad_requests"] == 0
    with pytest.raises(ValueError):
        b.submit([np.zeros((3,), np.float32)])
    assert b.stats["bad_requests"] == 1


def test_device_failure_is_500_and_counted():
    """A batch that raises fans the error out: each caller gets a 500 and
    the daemon keeps serving."""
    d, t = _serve(_StubArtifact(fail=True), 1.0, warmup=False)
    try:
        buf = io.BytesIO()
        np.savez(buf, in0=np.zeros((4,), np.float32))
        for _ in range(2):
            code, body = _http_error(urllib.request.Request(
                _url(d, "/infer"), data=buf.getvalue()))
            assert code == 500 and "device fault" in body["error"]
        with urllib.request.urlopen(_url(d, "/stats"), timeout=30) as r:
            assert json.loads(r.read())["errors"] == 2
    finally:
        d.stop()
        t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def e2e_daemon(tmp_path_factory):
    """Daemon over a small e2e artifact (uint8 RGB in, u16 pano out)."""
    tmp = tmp_path_factory.mktemp("e2eart")
    persp, base = zoo_pair(str(tmp), 128)
    cfg = MergeConfig(out_width=128, layout_name="3fold")
    path = str(tmp / "e2e.pt2")
    tserve.export_e2e(path, cfg, batch=2, persp_ckpt=persp,
                      baseline_ckpt=base, rgb_shape=(64, 128),
                      view_width=32, device="cpu")
    art = tserve.load(path)
    d, t = _serve(art, 10.0)
    yield d, art
    d.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _rgb(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(64, 128, 3) * 255).astype(np.uint8)


def test_infer_image_happy_path(e2e_daemon):
    """JPEG in -> 16-bit PNG depth panorama out, through the real HTTP
    stack, the port's codecs and the PNG16 writer: the PNG decodes to the
    artifact's direct output for the decoded image, bit for bit."""
    d, art = e2e_daemon
    rgb = _rgb(3)
    body = jpeg.encode(rgb, quality=95)
    with _post_image(d, body) as r:
        assert r.headers["Content-Type"] == "image/png"
        png = r.read()
    depth = tio.read_png("response", png)
    assert depth.dtype == np.uint16 and depth.shape == (64, 128)
    decoded = jpeg.decode(body)
    want = art(np.stack([decoded, decoded]))[0][0].numpy()
    np.testing.assert_array_equal(depth, want)
    assert png == tdaemon.encode_png16(want)
    # wrong-size image still 400s with the artifact's expectation
    code, err = _http_error(urllib.request.Request(
        _url(d, "/infer"), data=jpeg.encode(rgb[:32]),
        headers={"Content-Type": "image/jpeg"}))
    assert code == 400 and "artifact expects" in err["error"]


def test_infer_image_png_and_gray_bodies(e2e_daemon):
    """An 8-bit RGB PNG body and a gray JPEG (replicated to RGB) in one
    burst: each answer is the direct output for its pixels."""
    d, art = e2e_daemon
    rgb = _rgb(4)
    gray_body = jpeg.encode(rgb[..., 0])
    bodies = [tio.png_bytes(rgb, 1), gray_body]
    pixels = [rgb, np.repeat(jpeg.decode(gray_body)[..., None], 3, 2)]
    got = [None, None]

    def worker(i):
        ctype = "image/png" if i == 0 else "image/jpeg"
        with _post_image(d, bodies[i], ctype) as r:
            got[i] = tio.read_png("response", r.read())

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    want = art(np.stack(pixels))[0].numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], want[i])


def test_codec_refusal_is_400(e2e_daemon):
    """A progressive JPEG (its frame marker SOF2), which Pillow decodes and
    the port's codec does not, is a 400 carrying the codec's message, and
    so is a body that is no image; the daemon keeps serving."""
    d, _ = e2e_daemon
    body = bytearray(jpeg.encode(_rgb(5)))
    sof0 = body.index(b"\xff\xc0")
    body[sof0 + 1] = 0xC2
    code, err = _http_error(urllib.request.Request(
        _url(d, "/infer"), data=bytes(body),
        headers={"Content-Type": "image/jpeg"}))
    assert code == 400 and "progressive JPEG is not supported" in err["error"]
    code, err = _http_error(urllib.request.Request(
        _url(d, "/infer"), data=b"GIF89a" + bytes(64),
        headers={"Content-Type": "image/gif"}))
    assert code == 400 and "not a PNG, JPEG or BMP" in err["error"]
    with urllib.request.urlopen(_url(d, "/healthz"), timeout=30) as r:
        assert json.loads(r.read())["kind"] == "e2e"


def test_png16_writer_bytes_unchanged(tmp_path):
    """``io.png_bytes`` is what ``save_png16`` writes, byte for byte, and
    what the daemon answers with (level 1 unless PANODEPTH_PNG_LEVEL); the
    bytes are those the writer gave before it was split (sha256 pinned)."""
    rng = np.random.RandomState(0)
    u16 = rng.randint(0, 65536, (21, 34)).astype(np.uint16)
    path = tmp_path / "a.png"
    tio.save_png16(str(path), u16)
    data = path.read_bytes()
    assert hashlib.sha256(data).hexdigest() == (
        "8d94bbed1596f266e8ea0f567043273d7610fea9b7e2a7e6b7a0762346ff789e")
    assert data == tio.png_bytes(u16, 1) == tdaemon.encode_png16(u16)
    np.testing.assert_array_equal(tio.read_png("a", data), u16)
    rgb = (np.arange(12 * 9 * 3).reshape(12, 9, 3) % 256).astype(np.uint8)
    assert hashlib.sha256(tio.png_bytes(rgb, 6)).hexdigest() == (
        "5744be6ab1b41bb184c48c1ccb2c980653f21df5474e5d00842776dd2cdcdd75")
