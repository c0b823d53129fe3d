"""glTF import + scene build tests (ref: gltf/mod.rs, model.rs)."""

import numpy as np
import pytest

from raytracer2.models import procedural as proc
from raytracer2.scene import gltf
from raytracer2.scene.scene import build_scene


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    p = tmp_path_factory.mktemp("scenes") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    return gltf.load_file(p)


def test_cornell_structure(cornell):
    # 6 quads + 2 spheres = 8 nodes
    assert len(cornell.nodes) == 8
    assert cornell.positions.shape[1] == 3
    assert cornell.normals.shape == cornell.positions.shape
    assert cornell.colors.shape == (cornell.positions.shape[0], 4)
    assert cornell.uvs.shape == (cornell.positions.shape[0], 2)
    assert cornell.indices.dtype == np.uint32
    # indices reference valid vertices per-mesh
    for node in cornell.nodes:
        m = node.mesh
        idx = cornell.indices[m.index_offset:m.index_offset + m.index_count]
        assert idx.max() < m.vertex_count


def test_cornell_materials(cornell):
    light_nodes = [n for n in cornell.nodes
                   if any(e != 0 for e in n.mesh.material.emission)]
    assert len(light_nodes) == 1
    assert light_nodes[0].mesh.material.emission == (2.0, 2.0, 2.0)
    reds = [n for n in cornell.nodes
            if abs(n.mesh.material.base_color[0] - 0.65) < 1e-5]
    assert len(reds) == 1


def test_normals_unit_length(cornell):
    norms = np.linalg.norm(cornell.normals, axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_build_scene_counts(cornell):
    scene = build_scene(cornell)
    total_tris = sum(n.mesh.index_count // 3 for n in cornell.nodes)
    assert scene.num_triangles == total_tris
    # one emissive quad = 2 triangles
    assert scene.num_emissive_triangles == 2
    assert scene.tri_v0.shape == (total_tris, 3)
    assert scene.geometry.transform.shape == (8, 4, 4)


def test_scene_world_space_triangles(cornell):
    scene = build_scene(cornell)
    v0 = np.asarray(scene.tri_v0)
    e1 = np.asarray(scene.tri_edge1)
    e2 = np.asarray(scene.tri_edge2)
    # all verts inside box bounds (size 5 walls + interior spheres)
    for pts in (v0, v0 + e1, v0 + e2):
        assert np.all(np.abs(pts) <= 5.0 + 1e-4)
    # wall quads are non-degenerate (sphere pole tris are legitimately
    # zero-area and never intersect)
    areas = np.linalg.norm(np.cross(e1[:12], e2[:12]), axis=-1)
    assert np.all(areas > 1e-8)


def test_textured_scene():
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "tex.glb"
        proc.write_glb(p, proc.cornell_box_glb(textured_floor=True))
        model = gltf.load_file(p)
        assert len(model.images) == 1
        assert model.images[0].shape == (64, 64, 4)
        assert len(model.textures) == 1
        # default sampler at index 0, real sampler shifted to 1
        # (gltf/mod.rs:145-156, texture.rs:42)
        assert model.textures[0].sampler_index == 1
        assert len(model.samplers) == 2
        scene = build_scene(model)
        assert scene.textures.shape[0] == 1
        assert int(scene.texture_sizes[0, 0]) == 64
        tex_nodes = (np.asarray(scene.geometry.base_color_texture_index) > -1)
        assert tex_nodes.sum() == 1


def test_node_translation_applied():
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "grid.glb"
        proc.write_glb(p, proc.sphere_grid_glb(n=2, lat=4, lon=6))
        model = gltf.load_file(p)
        scene = build_scene(model)
        # sphere centers at x in {-1, +1}: world-space tris reflect translation
        v0 = np.asarray(scene.tri_v0)
        assert v0[:, 0].max() > 1.5 and v0[:, 0].min() < -1.5


def test_emissive_stress_light_count():
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "lights.glb"
        proc.write_glb(p, proc.emissive_stress_glb(num_lights=64))
        scene = build_scene(gltf.load_file(p))
        assert scene.num_emissive_triangles == 64 * 2


def _third_party_glb(tmp_path):
    """A GLB the repo's own GlbBuilder cannot produce: interleaved
    position/normal/uv in ONE bufferView with byteStride, a real PNG
    texture, and a non-default sampler (nearest + clamp/mirror). Exercises
    the accessor stride path (scene/gltf.py) and the sampler table
    (ref: gltf/texture.rs:1-118)."""
    import json
    import struct

    # two triangles (a quad), interleaved P3 N3 UV2 = 32-byte stride
    verts = [
        # x, y, z,   nx, ny, nz,  u, v
        (-1, 0, -1, 0, 1, 0, 0.0, 0.0),
        (1, 0, -1, 0, 1, 0, 2.0, 0.0),   # u=2 exercises wrapping
        (1, 0, 1, 0, 1, 0, 2.0, 2.0),
        (-1, 0, 1, 0, 1, 0, 0.0, 2.0),
    ]
    vbytes = b"".join(struct.pack("<8f", *v) for v in verts)
    indices = struct.pack("<6H", 0, 1, 2, 0, 2, 3)
    png = proc.checkerboard_png(8, 4)

    buf = vbytes + indices + png
    pad = (-len(buf)) % 4
    buf += b"\x00" * pad

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "accessors": [
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126,
             "count": 4, "type": "VEC3", "min": [-1, 0, -1],
             "max": [1, 0, 1]},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
             "count": 4, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 24, "componentType": 5126,
             "count": 4, "type": "VEC2"},
            {"bufferView": 1, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vbytes),
             "byteStride": 32},
            {"buffer": 0, "byteOffset": len(vbytes), "byteLength": 12},
            {"buffer": 0, "byteOffset": len(vbytes) + 12,
             "byteLength": len(png)},
        ],
        "buffers": [{"byteLength": len(buf)}],
        "images": [{"bufferView": 2, "mimeType": "image/png"}],
        "samplers": [{"magFilter": 9728, "minFilter": 9728,
                      "wrapS": 33071, "wrapT": 33648}],
        "textures": [{"source": 0, "sampler": 0}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1],
            "baseColorTexture": {"index": 0}}}],
    }
    jbytes = json.dumps(doc).encode()
    jbytes += b" " * ((-len(jbytes)) % 4)
    glb = (struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(jbytes) + 8 + len(buf))
           + struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
           + struct.pack("<II", len(buf), 0x004E4942) + buf)
    p = tmp_path / "third_party.glb"
    p.write_bytes(glb)
    return p


def test_third_party_interleaved_glb(tmp_path):
    """Loader handles interleaved accessors + PNG + explicit sampler —
    an asset layout our own writer never produces."""
    model = gltf.load_file(_third_party_glb(tmp_path))
    assert model.positions.shape == (4, 3)
    np.testing.assert_allclose(model.normals, [[0, 1, 0]] * 4, atol=1e-6)
    np.testing.assert_allclose(model.uvs[1], [2.0, 0.0], atol=1e-6)
    np.testing.assert_array_equal(model.indices, [0, 1, 2, 0, 2, 3])
    # sampler table: default at 0, ours shifted to 1 (texture.rs quirk)
    assert len(model.samplers) == 2
    s = model.samplers[model.textures[0].sampler_index]
    assert s.mag_filter == gltf.FILTER_NEAREST
    assert s.wrap_s == gltf.WRAP_CLAMP_TO_EDGE
    assert s.wrap_t == gltf.WRAP_MIRRORED_REPEAT
    scene = build_scene(model)
    assert scene.num_triangles == 2
    # texture_modes carries (nearest, clamp, mirror)
    np.testing.assert_array_equal(np.asarray(scene.texture_modes)[0],
                                  [1, 1, 2])


def test_sampler_modes_affect_sampling(tmp_path):
    """Nearest/clamp/mirror actually change sampled texels."""
    import jax.numpy as jnp

    from raytracer2.scene.scene import sample_texture_bilinear

    # 1x4 gradient texture
    tex = np.zeros((1, 1, 4, 4), np.float32)
    tex[0, 0, :, 0] = [0.0, 0.25, 0.5, 1.0]
    sizes = jnp.asarray([[4, 1]], jnp.int32)
    textures = jnp.asarray(tex)
    ti = jnp.asarray([0])
    uv = jnp.asarray([[1.25, 0.5]])  # u outside [0,1]

    def sample(modes):
        return float(sample_texture_bilinear(
            textures, sizes, ti, uv, modes=jnp.asarray([modes], jnp.int32)
        )[0, 0])

    repeat_linear = sample([0, 0, 0])
    clamp_linear = sample([0, 1, 0])
    mirror_linear = sample([0, 2, 0])
    nearest_repeat = sample([1, 0, 0])
    # u=1.25 -> repeat reads the gradient start, clamp sticks to the end
    assert clamp_linear == 1.0
    assert repeat_linear < 0.3
    # mirror reflects: u=1.25 ~ u=0.75 region (bright side)
    assert mirror_linear > 0.5
    # nearest at u=1.25 repeat -> texel 1 of the gradient exactly
    assert nearest_repeat == 0.25
