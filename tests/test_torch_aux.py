"""The port's auxiliaries against the JAX package and Pillow: the PNG
reader and writer (``io/png.py``) both ways; the network viewer protocol
on localhost, alone and served by the vanilla trainer;
``camera_from_message``; the Blender trajectory and animation files;
the span recorder (``span``, ``count``, ``recorded``, ``reset``) and
``trace``; ``write_scene_descriptor``; and
``rasterize_gaussians(debug=True)``'s non-finite snapshot.
"""

import json
import os
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from sugar_tpu.io import blender_interop as jblender
from sugar_tpu.raster import api as japi
from sugar_tpu.viewer import export as jexport
from sugar_tpu.viewer import network_gui as jgui
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.io import blender_interop
from sugar_tpu_torch.io.png import read_png, write_png
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.trainers.vanilla import TrainConfig, train_vanilla_3dgs
from sugar_tpu_torch.utils import profiling
from sugar_tpu_torch.viewer import export
from sugar_tpu_torch.viewer.network_gui import NetworkGUI, camera_from_message

torch.set_num_threads(1)


# --- PNG ------------------------------------------------------------------


def pattern(shape, seed=0):
    """Flat runs, a gradient and noise, so Pillow's adaptive filtering
    mixes filter types."""
    g = np.random.default_rng(seed)
    a = g.integers(0, 256, shape).astype(np.uint8)
    h = shape[0]
    a[: h // 4] = 7
    ramp = np.linspace(0, 255, shape[1]).astype(np.uint8)
    a[h // 4: h // 2] = ramp[None, :, None] if a.ndim == 3 else ramp[None, :]
    return a


@pytest.mark.parametrize("mode,shape", [("L", (37, 53)), ("RGB", (40, 61, 3)),
                                        ("RGBA", (33, 29, 4))])
def test_read_png_matches_pillow(tmp_path, mode, shape):
    a = pattern(shape)
    path = str(tmp_path / "p.png")
    Image.fromarray(a, mode).save(path)
    b = read_png(path)
    assert b.dtype == np.uint8 and b.shape == a.shape
    np.testing.assert_array_equal(b, np.asarray(Image.open(path)))


def png_filters(path):
    """The filter type of every row of an RGB PNG."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w = struct.unpack(">I", body[:4])[0]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[i] for i in range(0, len(raw), 1 + 3 * w)}


def test_read_png_several_idat_chunks(tmp_path):
    a = pattern((400, 300, 3), seed=3)
    path = str(tmp_path / "big.png")
    Image.fromarray(a).save(path)
    with open(path, "rb") as f:
        assert f.read().count(b"IDAT") > 1
    assert len(png_filters(path)) >= 3  # Pillow's adaptive filtering mixes filter types
    np.testing.assert_array_equal(read_png(path), a)


def filtered_png(path, a, idat_bytes=100):
    """An RGBA PNG whose row y uses filter type y % 5 (Pillow never picks
    Average for these images), split into IDAT chunks of idat_bytes."""
    h, w, bpp = a.shape
    x = a.reshape(h, w * bpp).astype(np.int64)
    rows = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(w * bpp, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[y, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][y % 5]
        rows.append(bytes([y % 5]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())
    data = zlib.compress(b"".join(rows))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
    for i in range(0, len(data), idat_bytes):
        out += chunk(b"IDAT", data[i:i + idat_bytes])
    with open(path, "wb") as f:
        f.write(out + chunk(b"IEND", b""))


def test_read_png_every_filter_type(tmp_path):
    a = pattern((23, 17, 4), seed=5)
    path = str(tmp_path / "filters.png")
    filtered_png(path, a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)  # Pillow agrees
    np.testing.assert_array_equal(read_png(path), a)


def test_write_png_reads_in_pillow(tmp_path):
    a = pattern((45, 70, 3), seed=1)
    path = str(tmp_path / "w.png")
    write_png(path, a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    np.testing.assert_array_equal(read_png(path), a)
    with pytest.raises(ValueError):
        write_png(path, a.astype(np.float32))
    with pytest.raises(ValueError):
        write_png(path, a[..., :2])


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "i16.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    with pytest.raises(ValueError):
        read_png(path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        read_png(str(bad))


# --- network viewer -------------------------------------------------------


def message(h, w):
    return dict(resolution_x=w, resolution_y=h, fov_x=1.0, fov_y=1.0,
                view_matrix=list(np.eye(4).reshape(-1)),
                view_projection_matrix=list(np.eye(4).reshape(-1)))


def client(host, port, msg, nbytes, received, source_path=""):
    """Send one camera message; read the image and the two JSON flags that
    follow it (keep-alive, the source path) before closing, so the server
    never writes to a closed socket."""
    c = socket.create_connection((host, port), timeout=30)
    payload = json.dumps(msg).encode()
    c.sendall(struct.pack("<I", len(payload)) + payload)
    tail = len(json.dumps(True)) + len(json.dumps(source_path))
    data = b""
    while len(data) < nbytes + tail:
        chunk = c.recv(4096)
        if not chunk:
            break
        data += chunk
    received["img"] = data[:nbytes]
    received["tail"] = data[nbytes:]
    c.close()


def test_protocol_roundtrip():
    """tests/test_aux.py:60-101 on the port's server, with a tensor image."""
    gui = NetworkGUI(port=0)
    host, port = gui.listener.getsockname()
    h = w = 4
    received = {}
    th = threading.Thread(target=client, args=(host, port, message(h, w), h * w * 3, received))
    th.start()
    deadline = time.time() + 30.0
    out = None
    while time.time() < deadline:
        out = gui.poll(lambda m: torch.full((h, w, 3), 0.5))
        if out is not None:
            break
        time.sleep(0.02)
    th.join(timeout=10)
    gui.close()
    assert not th.is_alive() and out is not None and out["resolution_x"] == w
    assert received["tail"] == b'true""'
    img = np.frombuffer(received["img"], np.uint8)
    assert (img == 127).all() or (img == 128).all()


def test_trainer_serves_protocol_round():
    """tests/test_aux.py:232-285 on the port: a client connected during
    training receives a live render."""
    gui = NetworkGUI(port=0)
    host, port = gui.listener.getsockname()
    h = w = 8
    received = {}
    th = threading.Thread(target=client, args=(host, port, message(h, w), h * w * 3, received,
                                                "/scene"))
    th.start()
    g = np.random.default_rng(0)
    pts = g.normal(size=(32, 3)).astype(np.float32) * 0.3 + [0, 0, 3]
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 16, 16, device="cpu")
    cfg = TrainConfig(iterations=150, sh_degree=0, capacity=64, densify_from=10_000,
                      densify_until=10_000, opacity_reset_every=10_000, k_max=64,
                      log_every=1_000, checkpoint_iterations=())
    train_vanilla_3dgs([cam], [np.full((16, 16, 3), 0.4, np.float32)], pts,
                       np.full((32, 3), 0.5, np.float32), extent=1.0, cfg=cfg, network_gui=gui,
                       source_path="/scene", device="cpu")
    th.join(timeout=10)
    gui.close()
    assert not th.is_alive()
    assert "img" in received and len(received["img"]) == h * w * 3
    assert received["tail"] == b'true"/scene"'


def test_camera_from_message_matches_jax():
    g = np.random.default_rng(2)
    R, _ = np.linalg.qr(g.normal(size=(3, 3)))
    wv = np.eye(4)
    wv[:3, :3], wv[:3, 3] = R, g.normal(size=3)
    msg = dict(resolution_x=32, resolution_y=24, fov_x=1.0, fov_y=0.8,
               view_matrix=list(wv.T.reshape(-1)),
               view_projection_matrix=list((g.normal(size=(4, 4)) + 4 * np.eye(4)).reshape(-1)))
    t, j = camera_from_message(msg, device="cpu"), jgui.camera_from_message(msg)
    for f in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    assert (t.height, t.width, t.tan_half_fov_x, t.tan_half_fov_y) == (
        j.height, j.width, j.tan_half_fov_x, j.tan_half_fov_y)


# --- Blender, timing, viewer export --------------------------------------


def test_blender_trajectory_and_animation_match_jax(tmp_path):
    g = np.random.default_rng(4)
    frames = []
    for i in range(3):
        m = np.eye(4)
        m[:3, :3], _ = np.linalg.qr(g.normal(size=(3, 3)))
        m[:3, 3] = g.normal(size=3) * 3
        frames.append(dict(matrix_world=m.tolist(), lens=35.0 + 10 * i))
    traj = str(tmp_path / "traj.json")
    with open(traj, "w") as f:
        json.dump(dict(frames=frames), f)
    bare = str(tmp_path / "bare.json")
    with open(bare, "w") as f:
        json.dump([dict(matrix_world=frames[0]["matrix_world"])], f)
    for path in (traj, bare):
        t = blender_interop.load_camera_trajectory(path, height=48, width=64, device="cpu")
        j = jblender.load_camera_trajectory(path, height=48, width=64)
        assert len(t) == len(j)
        for a, b in zip(t, j):
            for f in ("world_view", "full_proj", "cam_center"):
                np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
            assert (a.tan_half_fov_x, a.tan_half_fov_y) == (b.tan_half_fov_x, b.tan_half_fov_y)
    anim = str(tmp_path / "anim.json")
    with open(anim, "w") as f:
        json.dump([[dict(R=np.eye(3).tolist(), t=[1, 2, 3]), dict(R=np.eye(3).tolist())]], f)
    t, j = blender_interop.load_animation_transforms(anim), jblender.load_animation_transforms(anim)
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(a["R"], b["R"])
        np.testing.assert_array_equal(a["t"], b["t"])


def test_stage_timer_and_trace(tmp_path):
    """The recorder: nothing without a profiler; under ``trace`` nested
    spans with their parents and top span, counters, ``spans.json`` summed
    by name beside ``trace.json``; ``reset`` forgets."""
    x = torch.zeros(8)
    with profiling.span("a"):
        x = x + 1
    profiling.count("n", 3)
    assert profiling.recorded() == dict(spans=[], counters=[], dropped=0)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        for _ in range(2):
            with profiling.span("a"):
                with profiling.span("b"):
                    x = x + 1
                    profiling.count("n", torch.tensor(2))
                    profiling.count("n", 5)
        torch.ones(16) @ torch.ones(16)
    assert {"a", "b"} <= {e.name for e in prof.events()}
    rec = profiling.recorded()
    a1, b1 = rec["spans"][1], rec["spans"][0]
    assert (b1["name"], b1["parent"], b1["top"]) == ("b", a1["id"], a1["id"])
    assert a1["parent"] is None and a1["host_start_ns"] <= b1["host_start_ns"]
    assert b1["host_end_ns"] <= a1["host_end_ns"] and b1["device_ms"] is None
    assert [c["value"] for c in rec["counters"]] == [2, 5, 2, 5]
    assert rec["counters"][0]["span"] == b1["id"]
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with open(tmp_path / "trace" / "spans.json") as f:
        summ = json.load(f)
    assert summ["spans"]["a"]["count"] == 2 and summ["spans"]["b"]["count"] == 2
    assert summ["spans"]["a"]["host_ms"] >= summ["spans"]["b"]["host_ms"] > 0
    assert summ["spans"]["a"]["device_ms"] is None
    assert summ["counters"]["n"] == dict(count=4, total=14)
    profiling.reset()
    assert profiling.recorded() == dict(spans=[], counters=[], dropped=0)


def test_write_scene_descriptor_matches_jax(tmp_path):
    ply, obj_path = tmp_path / "r.ply", tmp_path / "m.obj"
    ply.write_text("ply")
    obj_path.write_text("v 0 0 0")
    with pytest.raises(FileNotFoundError):
        export.write_scene_descriptor(str(tmp_path / "v"), str(ply), str(obj_path))  # no PNG
    (tmp_path / "m.png").write_bytes(b"png")
    outs = []
    for pkg, fn in (("port", export.write_scene_descriptor),
                    ("jax", jexport.write_scene_descriptor)):
        out = fn(str(tmp_path / pkg), str(ply), str(obj_path))
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    with pytest.raises(FileNotFoundError):
        export.write_scene_descriptor(str(tmp_path / "v"), str(tmp_path / "none.ply"))


# --- debug=True -----------------------------------------------------------


def debug_scene(nan):
    g = np.random.default_rng(0)
    n = 16
    means = torch.as_tensor(g.normal(size=(n, 3)) * 0.3 + [0, 0, 3], dtype=torch.float32)
    if nan:
        means[3, 1] = float("nan")
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 16, 16, device="cpu")
    return dict(means3d=means, opacities=torch.full((n,), 0.8),
                scales=torch.full((n, 3), 0.1), quaternions=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
                colors=torch.as_tensor(g.uniform(0, 1, (n, 3)), dtype=torch.float32)), cam


@pytest.mark.parametrize("nan", [False, True])
def test_debug_snapshot(tmp_path, monkeypatch, capsys, nan):
    """Non-finite inputs leave an .npz with the JAX package's layout in
    $SUGAR_TPU_SNAPSHOT_DIR; finite ones leave nothing."""
    monkeypatch.setenv("SUGAR_TPU_SNAPSHOT_DIR", str(tmp_path))
    arrays, cam = debug_scene(nan)
    out = rasterize_gaussians(arrays["means3d"], arrays["opacities"], rc.from_camera(cam),
                              scales=arrays["scales"], quaternions=arrays["quaternions"],
                              colors=arrays["colors"], dup_capacity=2048, k_max=64, debug=True)
    files = sorted(os.listdir(tmp_path))
    if not nan:
        assert files == [] and bool(torch.isfinite(out["image"]).all())
        return
    assert len(files) == 1 and files[0].startswith("sugar_tpu_snapshot_")
    assert "non-finite values in ['means3d'" in capsys.readouterr().out
    with np.load(tmp_path / files[0]) as snap:
        ours = {k: snap[k] for k in snap.files}
    # The JAX package's writer on the same arrays, into its own directory.
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.setenv("SUGAR_TPU_SNAPSHOT_DIR", str(jdir))
    japi._debug_snapshot(dict({k: v.numpy() for k, v in arrays.items()}, shs=None,
                              image=out["image"].numpy()))
    (jfile,) = os.listdir(jdir)
    with np.load(jdir / jfile) as snap:
        assert sorted(snap.files) == sorted(ours)
        for k in snap.files:
            np.testing.assert_array_equal(ours[k], snap[k])
