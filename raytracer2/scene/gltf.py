"""glTF 2.0 / GLB scene import into flat SoA numpy arrays.

Ground-up parser (json + numpy + a zlib PNG codec; no glTF library is needed)
with the same import semantics as the reference loader
(src/gltf/mod.rs:50-174, src/gltf/material.rs, src/gltf/texture.rs):

- every supported primitive (has indices + positions + normals,
  gltf/mod.rs:170-174) is flattened once into a shared vertex/index soup with
  per-mesh vertex_offset / index_offset (gltf/mod.rs:62-125);
- vertices carry position / normal / color (default 1) / uv (default 0)
  (gltf/mod.rs:41-48, 88-101);
- one Node per (node, primitive) pair with the node's transform
  (gltf/mod.rs:127-138). The reference uses the node's LOCAL matrix only —
  parent transforms are ignored; `use_world_transforms=True` opts into proper
  hierarchy accumulation;
- materials keep base_color, base_color_texture_index (-1 if none), metallic,
  roughness, emissive (material.rs:4-23);
- images normalized to RGBA8 (gltf/image.rs:31-110); default sampler at
  index 0, texture sampler indices shifted by one (texture.rs:38-45,
  gltf/mod.rs:145-156).
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import struct
from pathlib import Path

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}

# Sampler enums (glTF spec values)
FILTER_NEAREST = 9728
FILTER_LINEAR = 9729
WRAP_CLAMP_TO_EDGE = 33071
WRAP_MIRRORED_REPEAT = 33648
WRAP_REPEAT = 10497


@dataclasses.dataclass
class Sampler:
    """(ref: gltf/texture.rs:8-13; defaults :47-61)."""

    mag_filter: int = FILTER_LINEAR
    min_filter: int = FILTER_LINEAR
    wrap_s: int = WRAP_REPEAT
    wrap_t: int = WRAP_REPEAT


@dataclasses.dataclass
class Texture:
    """(ref: gltf/texture.rs:1-5)."""

    image_index: int
    sampler_index: int  # index into CpuModel.samplers (0 = default)


@dataclasses.dataclass
class Material:
    """(ref: gltf/material.rs:4-10)."""

    emission: tuple[float, float, float] = (0.0, 0.0, 0.0)
    base_color: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    base_color_texture_index: int = -1
    metallic_factor: float = 1.0
    roughness: float = 1.0


@dataclasses.dataclass
class Mesh:
    """Flattened primitive range (ref: gltf/mod.rs:33-39)."""

    vertex_offset: int
    vertex_count: int
    index_offset: int
    index_count: int
    material: Material


@dataclasses.dataclass
class Node:
    """(ref: gltf/mod.rs:27-30). transform is a [4,4] float32 matrix with
    `M @ v` math convention (glam column-major array transposed on read)."""

    transform: np.ndarray
    mesh: Mesh


@dataclasses.dataclass
class CpuModel:
    """CPU-side flattened scene (ref: gltf/mod.rs:17-24), SoA layout."""

    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray  # [V, 3] f32
    colors: np.ndarray  # [V, 4] f32
    uvs: np.ndarray  # [V, 2] f32
    indices: np.ndarray  # [I] u32
    nodes: list[Node]
    images: list[np.ndarray]  # each [h, w, 4] u8 (RGBA)
    textures: list[Texture]
    samplers: list[Sampler]


def _read_glb(data: bytes) -> tuple[dict, bytes | None]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json, bin_chunk = None, None
    while offset + 8 <= len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8: offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # 'BIN'
            bin_chunk = chunk
        offset += 8 + chunk_len + (-chunk_len % 4) * 0
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, bin_chunk


def _decode_uri(uri: str, base_dir: Path) -> bytes:
    if uri.startswith("data:"):
        _, b64 = uri.split(",", 1)
        return base64.b64decode(b64)
    from urllib.parse import unquote

    return (base_dir / unquote(uri)).read_bytes()


class _Accessors:
    def __init__(self, doc: dict, buffers: list[bytes]):
        self.doc = doc
        self.buffers = buffers

    def read(self, accessor_index: int) -> np.ndarray:
        acc = self.doc["accessors"][accessor_index]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize
        out = np.zeros((count, n_comp), dtype=dtype)

        if "bufferView" in acc:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0) or n_comp * itemsize
            if stride == n_comp * itemsize:
                flat = np.frombuffer(
                    buf, dtype=dtype, count=count * n_comp, offset=base)
                out = flat.reshape(count, n_comp).copy()
            else:
                raw = np.frombuffer(buf, dtype=np.uint8)
                for i in range(count):
                    start = base + i * stride
                    out[i] = np.frombuffer(
                        raw, dtype=dtype, count=n_comp, offset=start)

        if acc.get("sparse"):
            sp = acc["sparse"]
            idx_acc = sp["indices"]
            idx_bv = self.doc["bufferViews"][idx_acc["bufferView"]]
            idx_dtype = _COMPONENT_DTYPES[idx_acc["componentType"]]
            idx = np.frombuffer(
                self.buffers[idx_bv["buffer"]], dtype=idx_dtype,
                count=sp["count"],
                offset=idx_bv.get("byteOffset", 0) + idx_acc.get("byteOffset", 0))
            val_acc = sp["values"]
            val_bv = self.doc["bufferViews"][val_acc["bufferView"]]
            vals = np.frombuffer(
                self.buffers[val_bv["buffer"]], dtype=dtype,
                count=sp["count"] * n_comp,
                offset=val_bv.get("byteOffset", 0) + val_acc.get("byteOffset", 0))
            out[idx] = vals.reshape(sp["count"], n_comp)

        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
            out = np.maximum(out, -1.0)
        return out


def _node_local_matrix(node: dict) -> np.ndarray:
    """Node transform as [4,4] math matrix. glTF stores `matrix` column-major
    (the Rust gltf crate's .matrix() returns columns, consumed by
    Mat4::from_cols_array_2d at model.rs:415)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], dtype=np.float32)
        m = _compose(r, m)
    if "translation" in node:
        m[:3, 3] += np.asarray(node["translation"], np.float32)
    return m


def _compose(r: np.ndarray, m: np.ndarray) -> np.ndarray:
    out = m.copy()
    out[:3, :] = r @ m[:3, :]
    return out


def _decode_image(data: bytes) -> np.ndarray:
    """Decode PNG/JPEG bytes to RGBA8 (ref: gltf/image.rs:31-110 normalizes
    every source format to RGBA8)."""
    from raytracer2.utils.png import UnsupportedPNG, decode_png

    try:
        img = decode_png(data)
    except UnsupportedPNG:
        img = None
    if img is not None:
        c = img.shape[-1]
        rgb = np.repeat(img, 3, axis=-1) if c == 1 else img[..., :3]
        alpha = (img[..., 3:] if c == 4
                 else np.full(img.shape[:2] + (1,), 255, np.uint8))
        return np.concatenate([rgb, alpha], axis=-1)
    try:  # other formats (JPEG, palette or 16-bit PNG) need Pillow
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(
            "decoding this texture (not an 8-bit gray/RGB/RGBA PNG) needs "
            "the Pillow package, which is not installed") from e
    img = PILImage.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def _is_primitive_supported(prim: dict) -> bool:
    """(ref: gltf/mod.rs:170-174)."""
    attrs = prim.get("attributes", {})
    return ("indices" in prim and "POSITION" in attrs and "NORMAL" in attrs
            and prim.get("mode", 4) == 4)


def load_file(path: str | Path, use_world_transforms: bool = False) -> CpuModel:
    """Load a .glb or .gltf file (ref: gltf/mod.rs:50-168).

    `use_world_transforms=False` replicates the reference's behavior of using
    each node's local matrix and ignoring the scene hierarchy
    (gltf/mod.rs:127-128); set True for spec-correct accumulated transforms.
    """
    path = Path(path)
    data = path.read_bytes()
    if data[:4] == b"glTF":
        doc, bin_chunk = _read_glb(data)
    else:
        doc, bin_chunk = json.loads(data), None

    buffers = []
    for buf in doc.get("buffers", []):
        if "uri" in buf:
            buffers.append(_decode_uri(buf["uri"], path.parent))
        else:
            buffers.append(bin_chunk or b"")
    acc = _Accessors(doc, buffers)

    positions, normals, colors, uvs, indices = [], [], [], [], []
    meshes: list[Mesh] = []
    mesh_index_redirect: dict[tuple[int, int], int] = {}
    materials = [_parse_material(m) for m in doc.get("materials", [])]

    v_total = 0
    i_total = 0
    for mesh_i, mesh in enumerate(doc.get("meshes", [])):
        for prim_i, prim in enumerate(mesh.get("primitives", [])):
            if not _is_primitive_supported(prim):
                continue
            key = (mesh_i, prim_i)
            if key in mesh_index_redirect:
                continue
            attrs = prim["attributes"]
            pos = acc.read(attrs["POSITION"]).astype(np.float32)
            nrm = acc.read(attrs["NORMAL"]).astype(np.float32)
            count = pos.shape[0]

            if "COLOR_0" in attrs:
                col = acc.read(attrs["COLOR_0"]).astype(np.float32)
                if col.shape[1] == 3:  # rgb -> rgba (into_rgba_f32)
                    col = np.concatenate(
                        [col, np.ones((count, 1), np.float32)], axis=1)
            else:
                col = np.ones((count, 4), np.float32)

            if "TEXCOORD_0" in attrs:
                uv = acc.read(attrs["TEXCOORD_0"]).astype(np.float32)
            else:
                uv = np.zeros((count, 2), np.float32)

            idx = acc.read(prim["indices"]).astype(np.uint32).reshape(-1)

            mesh_index_redirect[key] = len(meshes)
            meshes.append(Mesh(
                vertex_offset=v_total, vertex_count=count,
                index_offset=i_total, index_count=idx.shape[0],
                material=(materials[prim["material"]]
                          if "material" in prim else Material()),
            ))
            positions.append(pos)
            normals.append(nrm)
            colors.append(col)
            uvs.append(uv)
            indices.append(idx)
            v_total += count
            i_total += idx.shape[0]

    # Node flattening: one Node per (node, primitive).
    doc_nodes = doc.get("nodes", [])
    world = [None] * len(doc_nodes)
    if use_world_transforms:
        def fill(ni, parent):
            m = parent @ _node_local_matrix(doc_nodes[ni])
            world[ni] = m
            for c in doc_nodes[ni].get("children", []):
                fill(c, m)

        roots = set(range(len(doc_nodes)))
        for n in doc_nodes:
            roots -= set(n.get("children", []))
        for r in roots:
            fill(r, np.eye(4, dtype=np.float32))

    nodes: list[Node] = []
    for ni, node in enumerate(doc_nodes):
        if "mesh" not in node:
            continue
        transform = (world[ni] if use_world_transforms
                     else _node_local_matrix(node))
        if transform is None:
            transform = _node_local_matrix(node)
        for prim_i, prim in enumerate(
                doc["meshes"][node["mesh"]].get("primitives", [])):
            if not _is_primitive_supported(prim):
                continue
            nodes.append(Node(
                transform=transform.astype(np.float32),
                mesh=meshes[mesh_index_redirect[(node["mesh"], prim_i)]]))

    # Images
    images: list[np.ndarray] = []
    for img in doc.get("images", []):
        if "uri" in img:
            images.append(_decode_image(_decode_uri(img["uri"], path.parent)))
        else:
            bv = doc["bufferViews"][img["bufferView"]]
            buf = buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0)
            images.append(_decode_image(buf[start:start + bv["byteLength"]]))

    # Samplers: default at index 0 (gltf/mod.rs:145-156)
    samplers = [Sampler(
        mag_filter=FILTER_LINEAR, min_filter=FILTER_LINEAR,
        wrap_s=WRAP_REPEAT, wrap_t=WRAP_REPEAT)]
    for s in doc.get("samplers", []):
        samplers.append(Sampler(
            mag_filter=s.get("magFilter", FILTER_LINEAR),
            min_filter=s.get("minFilter", FILTER_LINEAR),
            wrap_s=s.get("wrapS", WRAP_REPEAT),
            wrap_t=s.get("wrapT", WRAP_REPEAT)))

    textures = [
        Texture(image_index=t["source"],
                sampler_index=t.get("sampler", -1) + 1)
        for t in doc.get("textures", [])
    ]

    def cat(parts, width, dtype):
        if parts:
            return np.concatenate(parts, axis=0).astype(dtype)
        return np.zeros((0, width), dtype) if width else np.zeros((0,), dtype)

    return CpuModel(
        positions=cat(positions, 3, np.float32),
        normals=cat(normals, 3, np.float32),
        colors=cat(colors, 4, np.float32),
        uvs=cat(uvs, 2, np.float32),
        indices=(np.concatenate(indices) if indices
                 else np.zeros((0,), np.uint32)),
        nodes=nodes, images=images, textures=textures, samplers=samplers,
    )


def _parse_material(m: dict) -> Material:
    pbr = m.get("pbrMetallicRoughness", {})
    tex = pbr.get("baseColorTexture")
    return Material(
        emission=tuple(m.get("emissiveFactor", [0.0, 0.0, 0.0])),
        base_color=tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])),
        base_color_texture_index=tex["index"] if tex is not None else -1,
        metallic_factor=pbr.get("metallicFactor", 1.0),
        roughness=pbr.get("roughnessFactor", 1.0),
    )
