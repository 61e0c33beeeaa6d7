"""Remote-viewer socket protocol (SIBR network_gui equivalent).

Port of ``sugar_tpu/viewer/network_gui.py``, which reimplements
gaussian_renderer/network_gui.py:18-86: a TCP server that receives a JSON
camera description + flags and replies with the raw rendered RGB bytes, so
an interactive viewer can watch training live. The wire format is the
reference protocol's (4-byte little-endian JSON length, JSON payload with
resolution/fov/view+proj matrices, raw uint8 RGB response), so
SIBR-compatible clients work unchanged.
"""

from __future__ import annotations

import json
import socket
import struct
import traceback
from typing import Callable

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0.0)
        self.conn: socket.socket | None = None

    def try_connect(self) -> None:
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except OSError:  # no client waiting (non-blocking accept)
            pass

    def _read(self) -> dict | None:
        raw = self.conn.recv(4)
        if len(raw) < 4:
            return None
        (n,) = struct.unpack("<I", raw)
        data = b""
        while len(data) < n:
            chunk = self.conn.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        return json.loads(data.decode("utf-8"))

    def poll(
        self,
        render_fn: Callable[[dict], "torch.Tensor | np.ndarray | None"],
        training_done: bool = False,
        source_path: str = "",
    ) -> dict | None:
        """One protocol round: receive a camera message, render, reply.
        ``render_fn(msg)`` returns an (H, W, 3) float image (a tensor or an
        array) or None. Returns the parsed message (so the trainer can read
        flags like keep_alive / scaling_modifier), or None when no client."""
        if self.conn is None:
            self.try_connect()
        if self.conn is None:
            return None
        try:
            msg = self._read()
            if msg is None:
                self.conn = None
                return None
            img = render_fn(msg)
            if img is not None:
                if isinstance(img, torch.Tensor):
                    img = img.detach().cpu().numpy()
                payload = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8).tobytes()
                self.conn.sendall(payload)
            self.conn.sendall(bytes(json.dumps(not training_done), "utf-8"))
            self.conn.sendall(bytes(json.dumps(source_path), "utf-8"))
            return msg
        except Exception:  # a viewer's fault must not stop training
            traceback.print_exc()
            self.conn = None
            return None

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.listener.close()


def camera_from_message(msg: dict, device: str | torch.device = "cuda") -> Camera:
    """Build a render camera on ``device`` from a protocol message (MiniCam
    fields: resolution, fov, znear/zfar, world-view + full-proj matrices)."""
    w, h = int(msg["resolution_x"]), int(msg["resolution_y"])
    fovx, fovy = float(msg["fov_x"]), float(msg["fov_y"])
    # Reference sends transposed (glm) matrices.
    wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4).T
    fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4).T
    cam_center = np.linalg.inv(wv)[:3, 3]
    return Camera(
        world_view=torch.as_tensor(np.ascontiguousarray(wv), device=device),
        full_proj=torch.as_tensor(np.ascontiguousarray(fp), device=device),
        cam_center=torch.as_tensor(cam_center.astype(np.float32), device=device),
        height=h,
        width=w,
        tan_half_fov_x=float(np.tan(fovx / 2)),
        tan_half_fov_y=float(np.tan(fovy / 2)),
    )
