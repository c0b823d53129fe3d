"""Procedural benchmark scenes, emitted as real GLB bytes.

The reference ships binary assets (box.glb, Sponza) that we cannot copy;
instead these builders generate equivalent scenes as spec-conformant GLB
so the glTF import path (scene/gltf.py) is exercised end-to-end. They cover
the BASELINE.md benchmark ladder: Cornell box, ~10k-tri sphere meshes, a
Sponza-class corridor scene, and emissive-heavy many-light scenes.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# Minimal GLB writer
# ---------------------------------------------------------------------------

class GlbBuilder:
    """Assembles meshes/materials/nodes into a GLB binary."""

    def __init__(self):
        self._bin = bytearray()
        self.accessors = []
        self.buffer_views = []
        self.meshes = []
        self.nodes = []
        self.materials = []
        self.images = []
        self.textures = []
        self.samplers = []

    def _push_blob(self, data: bytes, target: int | None) -> int:
        # 4-byte alignment
        while len(self._bin) % 4:
            self._bin.append(0)
        view = {"buffer": 0, "byteOffset": len(self._bin),
                "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        self._bin.extend(data)
        self.buffer_views.append(view)
        return len(self.buffer_views) - 1

    def _push_accessor(self, arr: np.ndarray, type_str: str,
                       component: int, target: int) -> int:
        view = self._push_blob(arr.tobytes(), target)
        acc = {
            "bufferView": view, "componentType": component,
            "count": arr.shape[0], "type": type_str,
        }
        if type_str == "VEC3" and component == 5126:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_material(self, base_color=(1, 1, 1, 1), emissive=(0, 0, 0),
                     metallic=0.0, roughness=1.0, texture_index=None) -> int:
        pbr = {"baseColorFactor": list(base_color),
               "metallicFactor": metallic, "roughnessFactor": roughness}
        if texture_index is not None:
            pbr["baseColorTexture"] = {"index": texture_index}
        self.materials.append(
            {"pbrMetallicRoughness": pbr, "emissiveFactor": list(emissive)})
        return len(self.materials) - 1

    def add_texture_png(self, png_bytes: bytes) -> int:
        view = self._push_blob(png_bytes, None)
        self.images.append({"bufferView": view, "mimeType": "image/png"})
        self.samplers.append({"magFilter": 9729, "minFilter": 9729,
                              "wrapS": 10497, "wrapT": 10497})
        self.textures.append({"source": len(self.images) - 1,
                              "sampler": len(self.samplers) - 1})
        return len(self.textures) - 1

    def add_mesh(self, positions: np.ndarray, normals: np.ndarray,
                 indices: np.ndarray, material: int,
                 uvs: np.ndarray | None = None,
                 colors: np.ndarray | None = None) -> int:
        attrs = {
            "POSITION": self._push_accessor(
                np.ascontiguousarray(positions, np.float32), "VEC3", 5126, 34962),
            "NORMAL": self._push_accessor(
                np.ascontiguousarray(normals, np.float32), "VEC3", 5126, 34962),
        }
        if uvs is not None:
            attrs["TEXCOORD_0"] = self._push_accessor(
                np.ascontiguousarray(uvs, np.float32), "VEC2", 5126, 34962)
        if colors is not None:
            attrs["COLOR_0"] = self._push_accessor(
                np.ascontiguousarray(colors, np.float32), "VEC4", 5126, 34962)
        idx = self._push_accessor(
            np.ascontiguousarray(indices.reshape(-1, 1), np.uint32),
            "SCALAR", 5125, 34963)
        self.meshes.append({"primitives": [
            {"attributes": attrs, "indices": idx, "material": material}]})
        return len(self.meshes) - 1

    def add_node(self, mesh: int, matrix: np.ndarray | None = None,
                 translation=None) -> int:
        node: dict = {"mesh": mesh}
        if matrix is not None:
            node["matrix"] = [float(x) for x in np.asarray(matrix).T.reshape(-1)]
        if translation is not None:
            node["translation"] = list(translation)
        self.nodes.append(node)
        return len(self.nodes) - 1

    def build(self) -> bytes:
        doc = {
            "asset": {"version": "2.0", "generator": "raytracer2"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "materials": self.materials,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [{"byteLength": len(self._bin)}],
        }
        if self.images:
            doc["images"] = self.images
            doc["textures"] = self.textures
            doc["samplers"] = self.samplers
        js = json.dumps(doc, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        bin_data = bytes(self._bin) + b"\x00" * (-len(self._bin) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_data)
        out = struct.pack("<III", 0x46546C67, 2, total)
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(bin_data), 0x004E4942) + bin_data
        return out


# ---------------------------------------------------------------------------
# Primitive mesh generators
# ---------------------------------------------------------------------------

def quad(corner: np.ndarray, edge_u: np.ndarray, edge_v: np.ndarray):
    """Two-triangle quad; normal = normalize(cross(edge_u, edge_v))."""
    corner = np.asarray(corner, np.float32)
    eu = np.asarray(edge_u, np.float32)
    ev = np.asarray(edge_v, np.float32)
    pos = np.stack([corner, corner + eu, corner + eu + ev, corner + ev])
    n = np.cross(eu, ev)
    n = n / np.linalg.norm(n)
    normals = np.broadcast_to(n, (4, 3)).copy()
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return pos.astype(np.float32), normals.astype(np.float32), uvs, indices


def uv_sphere(radius: float, n_lat: int, n_lon: int, center=(0, 0, 0)):
    """Latitude/longitude sphere, ~2*n_lat*n_lon triangles."""
    la = np.linspace(0, np.pi, n_lat + 1)
    lo = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(la, lo, indexing="ij")
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    pos = normals * radius + np.asarray(center, np.float32)
    uvs = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2)
    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j
            b = a + n_lon + 1
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return (pos.astype(np.float32), normals,
            uvs.astype(np.float32), np.asarray(idx, np.uint32))


def checkerboard_png(size: int = 64, cells: int = 8) -> bytes:
    """Generate a checkerboard PNG (tests the image decode path)."""
    from raytracer2.utils.png import encode_png

    x = np.arange(size)
    cell = size // cells
    pattern = ((x[:, None] // cell + x[None, :] // cell) % 2).astype(np.uint8)
    img = np.stack([pattern * 255, pattern * 160 + 60, 255 - pattern * 200],
                   axis=-1).astype(np.uint8)
    return encode_png(img)


# ---------------------------------------------------------------------------
# Benchmark scenes
# ---------------------------------------------------------------------------

def cornell_box_glb(light_emission: float = 1.0, box_size: float = 5.0,
                    textured_floor: bool = False) -> bytes:
    """Classic Cornell box: white floor/ceiling/back, red/green side walls,
    one emissive quad under the ceiling (BASELINE config 1)."""
    b = GlbBuilder()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), metallic=0.0)
    red = b.add_material(base_color=(0.65, 0.05, 0.05, 1.0), metallic=0.0)
    green = b.add_material(base_color=(0.12, 0.45, 0.15, 1.0), metallic=0.0)
    light = b.add_material(base_color=(1.0, 1.0, 1.0, 1.0),
                           emissive=(light_emission,) * 3)
    floor_mat = white
    if textured_floor:
        tex = b.add_texture_png(checkerboard_png())
        floor_mat = b.add_material(base_color=(1, 1, 1, 1), texture_index=tex)

    s = box_size
    # Interior faces; camera looks down +z from z=-2s (normals point inward)
    # interior-facing normals: cross(edge_u, edge_v) points into the box
    walls = [
        # floor y=-s (+y normal: cross(z, x) = +y)
        (quad([-s, -s, -s], [0, 0, 2 * s], [2 * s, 0, 0]), floor_mat),
        # ceiling y=+s (-y normal: cross(x, z) = -y)
        (quad([-s, s, -s], [2 * s, 0, 0], [0, 0, 2 * s]), white),
        # back z=+s (-z normal: cross(y, x) = -z)
        (quad([-s, -s, s], [0, 2 * s, 0], [2 * s, 0, 0]), white),
        # left x=-s (+x normal: cross(y, z) = +x)
        (quad([-s, -s, -s], [0, 2 * s, 0], [0, 0, 2 * s]), red),
        # right x=+s (-x normal: cross(z, y) = -x)
        (quad([s, -s, -s], [0, 0, 2 * s], [0, 2 * s, 0]), green),
        # light quad just under the ceiling (-y normal, facing the floor)
        (quad([-s * 0.4, s * 0.98, -s * 0.4],
              [s * 0.8, 0, 0], [0, 0, s * 0.8]), light),
    ]
    for (pos, nrm, uvs, idx), mat in walls:
        mesh = b.add_mesh(pos, nrm, idx, mat, uvs=uvs)
        b.add_node(mesh)
    # tall box + short box stand-ins: two spheres for curvature coverage
    pos, nrm, uvs, idx = uv_sphere(s * 0.3, 12, 16, center=(-s * 0.4, -s * 0.7, s * 0.2))
    b.add_node(b.add_mesh(pos, nrm, idx, white, uvs=uvs))
    pos, nrm, uvs, idx = uv_sphere(s * 0.22, 12, 16, center=(s * 0.45, -s * 0.78, -s * 0.3))
    b.add_node(b.add_mesh(pos, nrm, idx, green, uvs=uvs))
    return b.build()


def sphere_grid_glb(n: int = 3, lat: int = 24, lon: int = 32,
                    emissive_every: int = 0,
                    textured: bool = False) -> bytes:
    """n x n grid of ~(2*lat*lon)-triangle spheres (BASELINE config 2 scale);
    every `emissive_every`-th sphere is a light when nonzero.
    textured=True adds a checkerboard base-color texture to the floor and
    every third sphere (config 2's "textured shading")."""
    b = GlbBuilder()
    rng = np.random.default_rng(7)
    tex = b.add_texture_png(checkerboard_png()) if textured else None
    for i in range(n):
        for j in range(n):
            k = i * n + j
            color = tuple(rng.uniform(0.2, 0.9, 3)) + (1.0,)
            if emissive_every and k % emissive_every == 0:
                mat = b.add_material(base_color=color, emissive=(4.0, 3.5, 3.0))
            else:
                mat = b.add_material(
                    base_color=color,
                    metallic=float(rng.uniform(0, 1)),
                    texture_index=tex if textured and k % 3 == 1 else None)
            pos, nrm, uvs, idx = uv_sphere(0.8, lat, lon)
            mesh = b.add_mesh(pos, nrm, idx, mat, uvs=uvs)
            b.add_node(mesh, translation=(i * 2.0 - n + 1, 0.0, j * 2.0 - n + 1))
    # ground plane (+y normal)
    g = b.add_material(base_color=(0.8, 0.8, 0.8, 1.0), texture_index=tex)
    pos, nrm, uvs, idx = quad([-n * 2, -0.9, -n * 2],
                              [0, 0, 4 * n], [4 * n, 0, 0])
    b.add_node(b.add_mesh(pos, nrm, idx, g, uvs=uvs))
    return b.build()


def emissive_stress_glb(num_lights: int = 1024) -> bytes:
    """Emissive-heavy scene: a field of small emissive quads over a floor
    (BASELINE config 4: 1k+ area lights)."""
    b = GlbBuilder()
    rng = np.random.default_rng(11)
    floor = b.add_material(base_color=(0.6, 0.6, 0.6, 1.0))
    pos, nrm, uvs, idx = quad([-50, 0, -50], [0, 0, 100], [100, 0, 0])
    b.add_node(b.add_mesh(pos, nrm, idx, floor, uvs=uvs))
    side = int(np.ceil(np.sqrt(num_lights)))
    count = 0
    for i in range(side):
        for j in range(side):
            if count >= num_lights:
                break
            count += 1
            col = rng.uniform(0.5, 8.0, 3)
            mat = b.add_material(base_color=(1, 1, 1, 1), emissive=tuple(col))
            x = (i / side - 0.5) * 90
            z = (j / side - 0.5) * 90
            pos, nrm, uvs, idx = quad([x, 3.0, z], [0.5, 0, 0], [0, 0, 0.5])
            b.add_node(b.add_mesh(pos, nrm, idx, mat, uvs=uvs))
    return b.build()


def corridor_glb(segments: int = 24, pillars_per_side: int = 12,
                 lat: int = 10, lon: int = 14) -> bytes:
    """A Sponza-class corridor: walls/floor/ceiling segments + pillar rows +
    sphere clutter, a few hundred k triangles at default scale
    (BASELINE config 3 stand-in)."""
    b = GlbBuilder()
    tex = b.add_texture_png(checkerboard_png(128, 16))
    wall = b.add_material(base_color=(0.75, 0.7, 0.6, 1.0), texture_index=tex)
    stone = b.add_material(base_color=(0.5, 0.5, 0.55, 1.0))
    lamp = b.add_material(base_color=(1, 1, 1, 1), emissive=(6.0, 5.0, 4.0))
    seg_len = 4.0
    width, height = 12.0, 8.0
    for s in range(segments):
        z0 = s * seg_len
        # interior-facing normals (see cornell_box_glb)
        for (c, eu, ev, mat) in [
            ([-width / 2, 0, z0], [0, 0, seg_len], [width, 0, 0], wall),   # floor +y
            ([-width / 2, height, z0], [width, 0, 0], [0, 0, seg_len], wall),  # ceiling -y
            ([-width / 2, 0, z0], [0, height, 0], [0, 0, seg_len], wall),  # left +x
            ([width / 2, 0, z0], [0, 0, seg_len], [0, height, 0], wall),   # right -x
        ]:
            pos, nrm, uvs, idx = quad(c, eu, ev)
            b.add_node(b.add_mesh(pos, nrm, idx, mat, uvs=uvs))
        if s % 4 == 0:  # ceiling lamp (-y, facing the floor)
            pos, nrm, uvs, idx = quad([-1, height - 0.1, z0 + 1], [2, 0, 0], [0, 0, 2])
            b.add_node(b.add_mesh(pos, nrm, idx, lamp, uvs=uvs))
    # pillar rows: stacks of spheres (dense triangle load)
    for side in (-1, 1):
        for p in range(pillars_per_side):
            z = (p + 0.5) * segments * seg_len / pillars_per_side
            for y in (1.0, 3.0, 5.0):
                pos, nrm, uvs, idx = uv_sphere(
                    0.9, lat, lon, center=(side * width * 0.35, y, z))
                b.add_node(b.add_mesh(pos, nrm, idx, stone, uvs=uvs))
    return b.build()


def write_glb(path: str | Path, data: bytes) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path
