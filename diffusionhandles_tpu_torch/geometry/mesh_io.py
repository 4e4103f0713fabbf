"""Mesh file I/O: OBJ (with per-face UV indices), binary PLY and GLB.

The counterpart of the JAX package's `geometry/mesh_io.py` (reference:
diffhandles/mesh_io.py and mesh_io_obj.py) on this package's tensor
`Mesh`. Each writer makes the JAX writer's bytes for the same mesh (the
generator names in the files included), so a file written by either
package reads in the other. Readers build the mesh on `device` (default:
the GPU). GLB is what the core service's `export_meshes` returns
(reference: webapp/webapps/diffhandles_webapp.py:132-163).
"""

from __future__ import annotations

import json
import pathlib
import struct

import numpy as np
import torch

from diffusionhandles_tpu_torch.geometry.mesh import Mesh
from diffusionhandles_tpu_torch.utils.device import host_array, resolve_device

# the writers' generator names: the JAX package's, so both write one file
_GENERATOR = "diffusionhandles_tpu"


def _mesh(verts: np.ndarray, faces: np.ndarray, device) -> Mesh:
    device = resolve_device(device)
    return Mesh(verts=torch.from_numpy(np.array(verts, np.float32)).to(
        device), faces=torch.from_numpy(np.array(
            faces, np.int64).reshape(-1, 3)).to(device))


# ----------------------------------------------------------------- OBJ ----

def save_mesh_obj(path, mesh: Mesh, uvs=None, face_uv_indices=None) -> None:
    """Write an OBJ: vertices (with the 'color' attribute's first three
    channels appended, where the mesh has one), optional UVs, and faces
    with per-face UV indices when both are given (mesh_io_obj.py:404)."""
    lines = [f"# exported by {_GENERATOR}"]
    colors = mesh.vert_attributes.get("color")
    colors = None if colors is None else host_array(colors)
    for i, v in enumerate(host_array(mesh.verts)):
        if colors is not None:
            c = colors[i]
            lines.append("v {:.8g} {:.8g} {:.8g} {:.8g} {:.8g} {:.8g}"
                         .format(v[0], v[1], v[2], c[0], c[1],
                                 c[2] if len(c) > 2 else 0.0))
        else:
            lines.append("v {:.8g} {:.8g} {:.8g}".format(*v[:3]))
    if uvs is not None:
        for uv in host_array(uvs):
            lines.append("vt {:.8g} {:.8g}".format(uv[0], uv[1]))
    faces = host_array(mesh.faces)
    if uvs is not None and face_uv_indices is not None:
        for f, t in zip(faces, host_array(face_uv_indices)):
            lines.append("f {}/{} {}/{} {}/{}".format(
                f[0] + 1, t[0] + 1, f[1] + 1, t[1] + 1, f[2] + 1, t[2] + 1))
    else:
        for f in faces:
            lines.append("f {} {} {}".format(f[0] + 1, f[1] + 1, f[2] + 1))
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def load_mesh_obj(path, device=None):
    """Parse an OBJ (v, v with color, vt, f with v/vt[/vn] and negative
    indices; polygons as fans). Returns (Mesh, uvs [T, 2] or None,
    face_uv_indices [F, 3] or None), tensors on `device`."""
    verts, colors, uvs = [], [], []
    faces, face_uvs = [], []
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vals = [float(x) for x in parts[1:]]
            verts.append(vals[:3])
            if len(vals) >= 6:
                colors.append(vals[3:6])
        elif tag == "vt":
            uvs.append([float(parts[1]), float(parts[2])])
        elif tag == "f":
            idx, uvi = [], []
            for p in parts[1:]:
                comps = p.split("/")
                vi = int(comps[0])
                idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                if len(comps) > 1 and comps[1]:
                    ti = int(comps[1])
                    uvi.append(ti - 1 if ti > 0 else len(uvs) + ti)
            for k in range(1, len(idx) - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
                if len(uvi) == len(idx):
                    face_uvs.append([uvi[0], uvi[k], uvi[k + 1]])
    mesh = _mesh(np.asarray(verts, np.float32).reshape(-1, 3),
                 np.asarray(faces, np.int64), device)
    dev = mesh.verts.device
    if colors and len(colors) == len(verts):
        mesh.add_vert_attribute("color", torch.tensor(colors,
                                                      dtype=torch.float32))
    uv_arr = (torch.tensor(uvs, dtype=torch.float32, device=dev)
              if uvs else None)
    fuv_arr = (torch.tensor(face_uvs, dtype=torch.long, device=dev)
               if face_uvs and len(face_uvs) == len(faces) else None)
    return mesh, uv_arr, fuv_arr


# ----------------------------------------------------------------- PLY ----

_PLY_TYPES = {"float": "<f4", "uchar": "u1", "int": "<i4", "double": "<f8"}


def save_mesh_ply(path, mesh: Mesh) -> None:
    """Binary little-endian PLY with optional uchar vertex colors."""
    verts = host_array(mesh.verts).astype(np.float32)
    faces = host_array(mesh.faces).astype(np.int32)
    colors = mesh.vert_attributes.get("color")
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]
    fields = [("xyz", "<f4", 3)]
    if colors is not None:
        fields.append(("rgb", "u1", 3))
    rec = np.empty(len(verts), np.dtype(fields))
    rec["xyz"] = verts
    if colors is not None:
        rec["rgb"] = np.clip(host_array(colors)[:, :3] * 255, 0,
                             255).astype(np.uint8)
    tri = np.empty(len(faces), np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    tri["n"] = 3
    tri["i"] = faces
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())
        f.write(tri.tobytes())


def load_mesh_ply(path, device=None) -> Mesh:
    """Binary little-endian PLY reader (x/y/z plus optional uchar red /
    green / blue; other scalar vertex properties are skipped)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode()
    body = data[end:]
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for line in header.splitlines():
        p = line.split()
        if not p:
            continue
        if p[0] == "element":
            cur = p[1]
            if p[1] == "vertex":
                n_vert = int(p[2])
            elif p[1] == "face":
                n_face = int(p[2])
        elif p[0] == "property" and cur == "vertex" and p[1] != "list":
            vert_props.append((p[1], p[2]))
    vdtype = np.dtype([(name, _PLY_TYPES[t]) for t, name in vert_props])
    rec = np.frombuffer(body, vdtype, count=n_vert)
    verts = np.stack([rec[n] for n in ("x", "y", "z")], -1).astype(
        np.float32)
    # a color is read from red / green / blue (a file naming them r / g /
    # b gets zeros, as in the JAX reader)
    has_color = any(n in ("red", "r") for _, n in vert_props)
    colors = np.stack([rec[n].astype(np.float64) / 255.0 if n in vdtype.names
                       else np.zeros(n_vert) for n in ("red", "green",
                                                       "blue")],
                      -1).astype(np.float32)
    off = vdtype.itemsize * n_vert
    faces = np.zeros((n_face, 3), np.int64)
    for i in range(n_face):
        cnt = body[off]
        off += 1
        faces[i] = struct.unpack_from(f"<{cnt}i", body, off)[:3]
        off += 4 * cnt
    mesh = _mesh(verts, faces, device)
    if has_color:
        mesh.add_vert_attribute("color", torch.from_numpy(colors))
    return mesh


# ----------------------------------------------------------------- GLB ----

def save_mesh_glb(path, mesh: Mesh) -> None:
    """Minimal binary glTF 2.0: positions, indices, optional COLOR_0 (the
    demo UI loads these colored depth meshes, reference:
    diffhandles_webapp.py:132-163)."""
    verts = host_array(mesh.verts).astype(np.float32)
    faces = host_array(mesh.faces).astype(np.uint32)
    colors = mesh.vert_attributes.get("color")

    def pad4(b, fill=b"\x00"):
        return b + fill * ((4 - len(b) % 4) % 4)

    buffers = []
    views = []
    accessors = []

    def add_buffer(arr, target, comp_type, acc_type):
        raw = pad4(arr.tobytes())
        offset = sum(len(b) for b in buffers)
        buffers.append(raw)
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(arr.tobytes()), "target": target})
        acc = {"bufferView": len(views) - 1, "componentType": comp_type,
               "count": int(arr.shape[0]), "type": acc_type}
        if acc_type == "VEC3" and comp_type == 5126:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    pos_acc = add_buffer(verts, 34962, 5126, "VEC3")
    idx_acc = add_buffer(faces.reshape(-1), 34963, 5125, "SCALAR")
    attrs = {"POSITION": pos_acc}
    if colors is not None:
        c = host_array(colors).astype(np.float32)
        if c.shape[1] == 2:
            c = np.concatenate([c, np.zeros_like(c[:, :1])], axis=-1)
        attrs["COLOR_0"] = add_buffer(np.ascontiguousarray(c[:, :3]), 34962,
                                      5126, "VEC3")
    gltf = {
        "asset": {"version": "2.0", "generator": _GENERATOR},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs,
                                    "indices": idx_acc, "mode": 4}]}],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(b) for b in buffers)}],
    }
    json_chunk = pad4(json.dumps(gltf, separators=(",", ":")).encode(),
                      b" ")
    bin_chunk = b"".join(buffers)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)


_GLB_COMP_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
                    5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_GLB_TYPE_DIMS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def load_mesh_glb(path, device=None) -> Mesh:
    """Binary glTF 2.0 reader: positions, indices and the COLOR_0 /
    TEXCOORD_0 vertex attributes of the first primitive (reference:
    diffhandles/mesh_io.py:17-28 reads them through trimesh)."""
    with open(path, "rb") as f:
        magic, _version, _total = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError(f"{path}: not a GLB file")
        json_chunk = None
        bin_chunk = b""
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            length, ctype = struct.unpack("<II", header)
            data = f.read(length)
            if ctype == 0x4E4F534A:
                json_chunk = data
            elif ctype == 0x004E4942:
                bin_chunk = data
    if json_chunk is None:
        raise ValueError(f"{path}: missing GLB JSON chunk")
    gltf = json.loads(json_chunk.decode())

    def read_accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dtype = _GLB_COMP_DTYPES[acc["componentType"]]
        dims = _GLB_TYPE_DIMS[acc["type"]]
        count = acc["count"]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride")
        itemsize = np.dtype(dtype).itemsize * dims
        if stride and stride != itemsize:
            arr = np.stack([np.frombuffer(bin_chunk, dtype, count=dims,
                                          offset=start + i * stride)
                            for i in range(count)])
        else:
            arr = np.frombuffer(bin_chunk, dtype, count=count * dims,
                                offset=start)
            arr = arr.reshape(count, dims) if dims > 1 else arr
        return arr

    prim = gltf["meshes"][0]["primitives"][0]
    attrs = prim["attributes"]
    verts = np.asarray(read_accessor(attrs["POSITION"]), np.float32)
    mesh = _mesh(verts, read_accessor(prim["indices"]).astype(np.int64),
                 device)
    if "COLOR_0" in attrs:
        c = read_accessor(attrs["COLOR_0"]).astype(np.float32)
        comp = gltf["accessors"][attrs["COLOR_0"]]["componentType"]
        if comp == 5121:
            c = c / 255.0
        elif comp == 5123:
            c = c / 65535.0
        mesh.add_vert_attribute("color", torch.from_numpy(
            np.ascontiguousarray(c[:, :3])))
    if "TEXCOORD_0" in attrs:
        mesh.add_vert_attribute("uv", torch.from_numpy(np.array(
            read_accessor(attrs["TEXCOORD_0"]), np.float32)))
    return mesh


def save_mesh(path, mesh: Mesh, **kwargs) -> None:
    """Dispatch by extension (reference: mesh_io.py save_mesh)."""
    suffix = pathlib.Path(path).suffix.lower()
    if suffix == ".obj":
        save_mesh_obj(path, mesh, **kwargs)
    elif suffix == ".ply":
        save_mesh_ply(path, mesh)
    elif suffix == ".glb":
        save_mesh_glb(path, mesh)
    else:
        raise ValueError(f"Unsupported mesh format: {suffix}")


def load_mesh(path, device=None) -> Mesh:
    """Dispatch by extension (reference: mesh_io.py load_mesh)."""
    suffix = pathlib.Path(path).suffix.lower()
    if suffix == ".obj":
        return load_mesh_obj(path, device)[0]
    if suffix == ".ply":
        return load_mesh_ply(path, device)
    if suffix == ".glb":
        return load_mesh_glb(path, device)
    raise ValueError(f"Unsupported mesh format: {suffix}")
