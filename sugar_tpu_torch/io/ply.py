"""Minimal PLY reader/writer + the 3DGS Gaussian PLY contract.

Copy of ``sugar_tpu/io/ply.py`` (numpy only; the port keeps its own copy
so it imports nothing of the JAX package): the Gaussian PLY, the point
cloud PLY and the triangle-mesh PLY (float32 ``x y z``, optional uchar
``red green blue``, a ``face`` element of int ``vertex_indices`` lists). The
attribute layout is byte-compatible with the reference
(gaussian_model.py:177-256): a binary little-endian ``vertex`` element of
float32 properties ``x y z nx ny nz f_dc_0..2 f_rest_* opacity scale_*
rot_*``, ``f_rest`` channel-major. Files written by either package load in
the other.
"""

from __future__ import annotations

import io as _io
from typing import Mapping

import numpy as np

_PLY_DTYPES = {
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "short": "i2",
    "ushort": "u2",
    "char": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "int8": "i1",
}
_INV_DTYPES = {
    "f4": "float",
    "f8": "double",
    "i4": "int",
    "u4": "uint",
    "i2": "short",
    "u2": "ushort",
    "i1": "char",
    "u1": "uchar",
}


def read_ply(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Read a PLY file -> {element_name: {property: array}}.

    List properties (e.g. face vertex_indices) are returned as (N, K) arrays
    when fixed-size, else as object arrays.
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    elements: list[tuple[str, int, list]] = []  # (name, count, props)
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], "list", _PLY_DTYPES[tok[2]], _PLY_DTYPES[tok[3]]))
            else:
                elements[-1][2].append((tok[2], "scalar", _PLY_DTYPES[tok[1]]))

    out: dict[str, dict[str, np.ndarray]] = {}
    if fmt == "ascii":
        text_rows = body.decode("ascii").split("\n")
        row_i = 0
        for name, count, props in elements:
            cols: dict[str, list] = {p[0]: [] for p in props}
            for _ in range(count):
                vals = text_rows[row_i].split()
                row_i += 1
                k = 0
                for p in props:
                    if p[1] == "list":
                        ln = int(vals[k])
                        cols[p[0]].append(np.array(vals[k + 1 : k + 1 + ln], dtype=p[3]))
                        k += 1 + ln
                    else:
                        cols[p[0]].append(np.array(vals[k], dtype=p[2]))
                        k += 1
            out[name] = {
                k2: (np.stack(v) if v and isinstance(v[0], np.ndarray) and v[0].ndim else np.array(v))
                for k2, v in cols.items()
            }
        return out

    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    buf = _io.BytesIO(body)
    for name, count, props in elements:
        if all(p[1] == "scalar" for p in props):
            dt = np.dtype([(p[0], "<" + p[2]) for p in props])
            arr = np.frombuffer(buf.read(dt.itemsize * count), dtype=dt)
            out[name] = {p[0]: np.ascontiguousarray(arr[p[0]]) for p in props}
        else:
            cols = {p[0]: [] for p in props}
            for _ in range(count):
                for p in props:
                    if p[1] == "list":
                        cnt_dt = np.dtype("<" + p[2])
                        ln = int(np.frombuffer(buf.read(cnt_dt.itemsize), cnt_dt)[0])
                        val_dt = np.dtype("<" + p[3])
                        cols[p[0]].append(
                            np.frombuffer(buf.read(val_dt.itemsize * ln), val_dt)
                        )
                    else:
                        dt = np.dtype("<" + p[2])
                        cols[p[0]].append(np.frombuffer(buf.read(dt.itemsize), dt)[0])
            out[name] = {
                k2: (np.stack(v) if v and isinstance(v[0], np.ndarray) else np.array(v))
                for k2, v in cols.items()
            }
    return out


def write_ply(
    path: str,
    elements: Mapping[str, Mapping[str, np.ndarray]],
    list_props: Mapping[str, Mapping[str, str]] | None = None,
    comments: list[str] | None = None,
) -> None:
    """Write a binary little-endian PLY.

    ``elements`` maps element name -> {property: (N,) scalar array or (N, K)
    list array}. Properties in ``list_props[elem]`` are written as lists
    (value = dtype string like 'int').
    """
    list_props = list_props or {}
    lines = ["ply", "format binary_little_endian 1.0"]
    for c in comments or []:
        lines.append(f"comment {c}")
    bodies: list[bytes] = []
    for name, props in elements.items():
        first = next(iter(props.values()))
        count = first.shape[0]
        lines.append(f"element {name} {count}")
        is_list = {k: k in list_props.get(name, {}) for k in props}
        for k, v in props.items():
            if is_list[k]:
                vdt = _INV_DTYPES[np.dtype(v.dtype).str[1:]]
                lines.append(f"property list uchar {vdt} {k}")
            else:
                lines.append(f"property {_INV_DTYPES[np.dtype(v.dtype).str[1:]]} {k}")
        if any(is_list.values()):
            chunks = []
            keys = list(props)
            for i in range(count):
                for k in keys:
                    v = props[k]
                    if is_list[k]:
                        row = np.ascontiguousarray(v[i])
                        chunks.append(np.array([len(row)], np.uint8).tobytes())
                        chunks.append(row.astype(row.dtype.newbyteorder("<")).tobytes())
                    else:
                        chunks.append(
                            np.asarray(v[i]).astype(np.dtype(v.dtype).newbyteorder("<")).tobytes()
                        )
            bodies.append(b"".join(chunks))
        else:
            dt = np.dtype([(k, "<" + np.dtype(v.dtype).str[1:]) for k, v in props.items()])
            rec = np.empty(count, dtype=dt)
            for k, v in props.items():
                rec[k] = v
            bodies.append(rec.tobytes())
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        for b in bodies:
            f.write(b)


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,
    sh_dc: np.ndarray,  # (N, 3)
    sh_rest: np.ndarray,  # (N, 3, K-1) channel-major
    opacity_logit: np.ndarray,  # (N,)
    log_scales: np.ndarray,  # (N, S)
    quaternions: np.ndarray,  # (N, 4)
) -> None:
    """Write the canonical 3DGS gaussian PLY (pre-activation values)."""
    n = xyz.shape[0]
    props: dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        props[k] = xyz[:, i].astype(np.float32)
    for k in ("nx", "ny", "nz"):
        props[k] = np.zeros(n, np.float32)
    for i in range(3):
        props[f"f_dc_{i}"] = sh_dc[:, i].astype(np.float32)
    rest_flat = sh_rest.reshape(n, -1)
    for i in range(rest_flat.shape[1]):
        props[f"f_rest_{i}"] = rest_flat[:, i].astype(np.float32)
    props["opacity"] = opacity_logit.reshape(n).astype(np.float32)
    for i in range(log_scales.shape[1]):
        props[f"scale_{i}"] = log_scales[:, i].astype(np.float32)
    for i in range(4):
        props[f"rot_{i}"] = quaternions[:, i].astype(np.float32)
    write_ply(path, {"vertex": props})


def load_gaussian_ply(path: str) -> dict[str, np.ndarray]:
    """Read a 3DGS gaussian PLY -> dict of pre-activation arrays."""
    v = read_ply(path)["vertex"]
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    sh_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1)
    rest_names = sorted(
        (k for k in v if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    if rest_names:
        rest = np.stack([v[k] for k in rest_names], axis=1).reshape(n, 3, -1)
    else:
        rest = np.zeros((n, 3, 0), np.float32)
    scale_names = sorted(
        (k for k in v if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    rot_names = sorted(
        (k for k in v if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    return dict(
        xyz=xyz.astype(np.float32),
        sh_dc=sh_dc.astype(np.float32),
        sh_rest=rest.astype(np.float32),
        opacity_logit=v["opacity"].astype(np.float32),
        log_scales=np.stack([v[k] for k in scale_names], axis=1).astype(np.float32),
        quaternions=np.stack([v[k] for k in rot_names], axis=1).astype(np.float32),
    )


def save_point_cloud_ply(
    path: str, xyz: np.ndarray, colors: np.ndarray | None = None, normals: np.ndarray | None = None
) -> None:
    """Point cloud with optional uchar RGB + float normals (storePly format,
    dataset_readers.py:107-128)."""
    props: dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        props[k] = xyz[:, i].astype(np.float32)
    if normals is not None:
        for i, k in enumerate(("nx", "ny", "nz")):
            props[k] = normals[:, i].astype(np.float32)
    if colors is not None:
        c = colors
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        for i, k in enumerate(("red", "green", "blue")):
            props[k] = c[:, i]
    write_ply(path, {"vertex": props})


def save_mesh_ply(
    path: str, vertices: np.ndarray, faces: np.ndarray, vertex_colors: np.ndarray | None = None
) -> None:
    """Triangle mesh PLY (vertex + face elements)."""
    vprops: dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        vprops[k] = vertices[:, i].astype(np.float32)
    if vertex_colors is not None:
        c = vertex_colors
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        for i, k in enumerate(("red", "green", "blue")):
            vprops[k] = c[:, i]
    write_ply(
        path,
        {"vertex": vprops, "face": {"vertex_indices": faces.astype(np.int32)}},
        list_props={"face": {"vertex_indices": "int"}},
    )


def load_mesh_ply(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Read (vertices, faces, colors or None) from a mesh PLY."""
    d = read_ply(path)
    v = d["vertex"]
    verts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    fkey = "vertex_indices" if "vertex_indices" in d.get("face", {}) else "vertex_index"
    faces = np.asarray(d["face"][fkey], dtype=np.int64) if "face" in d else np.zeros((0, 3), np.int64)
    colors = None
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=1)
    return verts, faces, colors
