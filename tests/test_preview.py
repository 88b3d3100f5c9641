"""Live MJPEG preview server (app/preview.py) — the headless analog of
the reference's GLFW present path (app.c:86-97, renderer.c:2199-2209)."""

import threading
import urllib.request

import numpy as np

from csgrenderer.app.preview import PreviewServer, _encode_frame


def test_encode_frame_roundtrip():
    img = (np.arange(8 * 6 * 3, dtype=np.uint8).reshape(6, 8, 3) * 3) % 255
    data, ctype = _encode_frame(img)
    assert len(data) > 0
    if ctype == "image/jpeg":
        assert data[:2] == b"\xff\xd8"  # JPEG SOI
    else:
        assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_frame_endpoint_and_float_sink():
    srv = PreviewServer(port=0)  # ephemeral port
    try:
        host, port = srv.start()
        # 503 before the first publish
        try:
            urllib.request.urlopen(f"http://{host}:{port}/frame", timeout=5)
            assert False, "expected 503"
        except urllib.error.HTTPError as e:
            assert e.code == 503
        # float radiance goes through the tonemap path (App sink contract)
        srv.sink(0, np.full((6, 8, 3), 0.25, np.float32))
        with urllib.request.urlopen(
            f"http://{host}:{port}/frame", timeout=5
        ) as r:
            body = r.read()
            assert r.headers["Content-Type"] in ("image/jpeg", "image/png")
            assert len(body) > 0
        with urllib.request.urlopen(
            f"http://{host}:{port}/", timeout=5
        ) as r:
            assert b"/stream" in r.read()
    finally:
        srv.stop()


def test_stream_delivers_published_frames():
    srv = PreviewServer(port=0)
    try:
        host, port = srv.start()
        srv.publish(np.zeros((4, 4, 3), np.uint8))
        got = {}

        def watch():
            req = urllib.request.urlopen(
                f"http://{host}:{port}/stream", timeout=10
            )
            assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
            # read through the first part (boundary + headers + payload)
            line = req.readline()
            assert line.strip() == b"--csgrframe"
            headers = {}
            while True:
                ln = req.readline().strip()
                if not ln:
                    break
                k, v = ln.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
            n = int(headers[b"content-length"])
            got["frame"] = req.read(n)
            req.close()

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert len(got["frame"]) > 0
    finally:
        srv.stop()


def test_input_endpoint_enqueues_events():
    """Round 4: browser input (app.c:204's poll analog). /input events land
    in the queue in order; bad types are rejected; poll_events drains."""
    srv = PreviewServer(port=0)
    try:
        host, port = srv.start()

        def get(q):
            req = urllib.request.Request(f"http://{host}:{port}/input?{q}")
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        assert get("type=key&code=Escape") == 204
        assert get("type=orbit&dyaw=0.1&dpitch=-0.05&dzoom=0.5") == 204
        assert get("type=close") == 204
        assert get("type=evil") == 400
        assert get("nonsense=1") == 400
        evs = srv.poll_events()
        assert [e["type"] for e in evs] == ["key", "orbit", "close"]
        assert evs[0]["code"] == "Escape"
        assert float(evs[1]["dyaw"]) == 0.1
        assert srv.poll_events() == []  # drained
    finally:
        srv.stop()


def test_index_page_sends_input():
    srv = PreviewServer(port=0)
    try:
        host, port = srv.start()
        with urllib.request.urlopen(f"http://{host}:{port}/", timeout=5) as r:
            page = r.read()
        assert b"/input?" in page and b"mousedown" in page
    finally:
        srv.stop()
