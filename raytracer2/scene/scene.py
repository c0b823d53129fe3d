"""Device scene: SoA jnp arrays + geometry table + material fetch.

JAX equivalent of the reference's GPU scene build (src/model.rs:185-476)
and geometry/material fetch (src/shaders/Hit.glsl):

- vertex/index soup uploaded as SoA arrays (model.rs:357-373);
- a GeometryInfo record per node {transform, base_color, texture index,
  metallic, index/vertex offset, emission, roughness} (model.rs:12-23,414-426);
- instead of a driver BLAS, triangles are pre-transformed to world space into
  tri_v0/v1/v2 arrays (the BLAS build consumed the same per-node transforms,
  model.rs:193-219, 379-459) which feed LBVH construction / intersection;
- emissive-triangle count == `lights` (model.rs:399-412);
- textures decoded sRGB->linear and stacked zero-padded to the max extent
  (the bindless texture array, RtxdiApplicationBridge.glsl:60).

Material-fetch quirks preserved behind flags (SURVEY.md §7): roughness forced
to 1.0 and emission scaled x12 (Hit.glsl:40-41); normals transformed by the
plain node matrix, not its inverse transpose (Hit.glsl:27).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer2.scene.gltf import CpuModel
from raytracer2.utils.brdf import normalize as v_normalize

# Reference quirks (Hit.glsl:40-41) — default on for image parity.
ROUGHNESS_OVERRIDE: float | None = 1.0
EMISSION_SCALE: float = 12.0


class GeometryTable(NamedTuple):
    """Per-node geometry records (ref: model.rs:12-23)."""

    transform: jax.Array  # [G, 4, 4]
    base_color: jax.Array  # [G, 4]
    base_color_texture_index: jax.Array  # [G] int32 (-1 = none)
    metallic_factor: jax.Array  # [G]
    index_offset: jax.Array  # [G] uint32
    vertex_offset: jax.Array  # [G] uint32
    emission: jax.Array  # [G, 4]
    roughness: jax.Array  # [G]


class Scene(NamedTuple):
    """Full device scene. All leaves are jnp arrays (replicated per chip)."""

    # vertex soup (ref: model.rs:357-373, object space)
    positions: jax.Array  # [V, 3]
    normals: jax.Array  # [V, 3]
    colors: jax.Array  # [V, 4]
    uvs: jax.Array  # [V, 2]
    indices: jax.Array  # [I] uint32
    geometry: GeometryTable  # [G]

    # world-space triangle soup for traversal (replaces the BLAS)
    tri_v0: jax.Array  # [T, 3]
    tri_edge1: jax.Array  # [T, 3] v1 - v0
    tri_edge2: jax.Array  # [T, 3] v2 - v0
    tri_geometry: jax.Array  # [T] int32 geometry index
    tri_primitive: jax.Array  # [T] int32 primitive id within its geometry

    # stacked textures: [NT, H, W, 4] linear float32, zero-padded; sizes [NT,2]
    textures: jax.Array
    texture_sizes: jax.Array  # [NT, 2] int32 (w, h)
    # per-texture sampler state (ref: gltf/texture.rs:1-118 sampler table):
    # [NT, 3] i32 = (nearest_filter, wrap_s, wrap_t); wrap: 0 repeat,
    # 1 clamp-to-edge, 2 mirrored-repeat
    texture_modes: jax.Array

    # environment map (equirect, linear RGB); [1,1,3] zeros if absent
    skybox: jax.Array  # [h, w, 3]

    # packed fetch table (one wide row gather replaces many narrow
    # ones). [T, 80] f32: all three vertices' attributes per triangle
    # (3 x 16 wide: normal 0:3 | uv 3:5 | color 5:9) followed at 48:80
    # by the owning geometry's geom_row COPY, so the whole material
    # fetch is ONE row gather when the caller has the triangle id.
    tri_attrs: jax.Array
    geom_rows: jax.Array  # [G, 32] f32: see _GEOM_ROW_* layout below
    geom_tri_base: jax.Array  # [G] i32 first world-triangle id per geometry

    # static metadata
    num_triangles: int
    num_geometries: int
    num_emissive_triangles: int  # == model.lights (model.rs:399-412)
    # True when every texture uses the default sampler (linear + repeat):
    # the hot sampling path then skips the per-lane mode selects
    default_samplers_only: bool = True
    # False when the model carries no images: the hot shading path then
    # skips texture sampling entirely (the dummy 1x1 white texture would
    # still cost ~6 [N]-row gathers per materialized shade at 1080p)
    has_textures: bool = True

    # host (numpy) copies of the world triangle soup, consumed by the
    # host-side cluster/LBVH builders (the reference's BLAS build also runs
    # from host-visible buffers, model.rs:379-459); they originate on the
    # host in build_scene, so keeping them saves a device-to-host copy
    host_tri_v0: np.ndarray | None = None
    host_tri_edge1: np.ndarray | None = None
    host_tri_edge2: np.ndarray | None = None
    # host copies consumed by prepare_lights (emissive masking / per-geometry
    # triangle counts), for the same reason
    host_emission: np.ndarray | None = None  # [G, 4]
    host_tri_geometry: np.ndarray | None = None  # [T] int32

    # quad-packed texture table [NT*H*W, 16]: row (t, y, x) holds the full
    # 2x2 bilinear window (texels (x,y), (x+1,y), (x,y+1), (x+1,y+1)) with
    # REPEAT wrapping baked in, so a bilinear sample is ONE row gather
    # instead of four. Only valid for the default glTF
    # sampler (linear + repeat); None when any texture needs another mode.
    textures_quad: jax.Array | None = None


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """sRGB EOTF (Vulkan R8G8B8A8_SRGB sampling, model.rs:241)."""
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def build_scene(model: CpuModel, skybox: np.ndarray | None = None) -> Scene:
    """Build the device scene from a CPU model (ref: model.rs:185-476)."""
    g = len(model.nodes)

    transforms = np.stack(
        [n.transform for n in model.nodes], axis=0) if g else np.zeros((0, 4, 4), np.float32)
    base_colors = np.array(
        [n.mesh.material.base_color for n in model.nodes], np.float32).reshape(g, 4)
    tex_idx = np.array(
        [n.mesh.material.base_color_texture_index for n in model.nodes],
        np.int32)
    metallic = np.array(
        [n.mesh.material.metallic_factor for n in model.nodes], np.float32)
    # emission w=1.0 (model.rs:405-410)
    emission = np.array(
        [[*n.mesh.material.emission, 1.0] for n in model.nodes],
        np.float32).reshape(g, 4)
    roughness = np.array(
        [n.mesh.material.roughness for n in model.nodes], np.float32)
    index_offsets = np.array(
        [n.mesh.index_offset for n in model.nodes], np.uint32)
    vertex_offsets = np.array(
        [n.mesh.vertex_offset for n in model.nodes], np.uint32)
    index_counts = np.array(
        [n.mesh.index_count for n in model.nodes], np.uint32)

    # lights = sum of emissive-geometry triangle counts (model.rs:399-413)
    is_emissive = np.any(emission[:, :3] != 0.0, axis=-1)
    num_lights = int((index_counts[is_emissive] // 3).sum())

    # world-space triangle soup (BLAS equivalent)
    tri_v0s, tri_e1s, tri_e2s, tri_geos, tri_prims = [], [], [], [], []
    tri_vids = []
    tri_bases = np.zeros(max(g, 1), np.int32)
    tri_cursor = 0
    for gi, node in enumerate(model.nodes):
        m = node.mesh
        idx = model.indices[m.index_offset: m.index_offset + m.index_count]
        idx = idx.reshape(-1, 3).astype(np.int64) + m.vertex_offset
        p = model.positions[idx]  # [t, 3, 3]
        t4 = node.transform
        pw = p @ t4[:3, :3].T + t4[:3, 3]
        tri_v0s.append(pw[:, 0])
        tri_e1s.append(pw[:, 1] - pw[:, 0])
        tri_e2s.append(pw[:, 2] - pw[:, 0])
        n_tris = idx.shape[0]
        tri_geos.append(np.full(n_tris, gi, np.int32))
        tri_prims.append(np.arange(n_tris, dtype=np.int32))
        tri_vids.append(idx.astype(np.int32))
        tri_bases[gi] = tri_cursor
        tri_cursor += n_tris

    def cat3(parts):
        return (np.concatenate(parts, axis=0).astype(np.float32)
                if parts else np.zeros((0, 3), np.float32))

    tri_v0 = cat3(tri_v0s)
    tri_e1 = cat3(tri_e1s)
    tri_e2 = cat3(tri_e2s)
    tri_geo = (np.concatenate(tri_geos) if tri_geos
               else np.zeros((0,), np.int32))
    tri_prim = (np.concatenate(tri_prims) if tri_prims
                else np.zeros((0,), np.int32))

    # textures -> linear float, stacked zero-padded (dummy 1x1 white if none,
    # model.rs:289-355)
    if model.images and model.textures:
        from raytracer2.scene.gltf import (
            FILTER_NEAREST, WRAP_CLAMP_TO_EDGE, WRAP_MIRRORED_REPEAT)

        def wrap_code(mode):
            if mode == WRAP_CLAMP_TO_EDGE:
                return 1
            if mode == WRAP_MIRRORED_REPEAT:
                return 2
            return 0

        imgs = []
        sizes = []
        modes = []
        for t in model.textures:
            img = model.images[t.image_index].astype(np.float32) / 255.0
            rgb = _srgb_to_linear(img[..., :3])
            a = img[..., 3:4]
            imgs.append(np.concatenate([rgb, a], axis=-1))
            sizes.append((img.shape[1], img.shape[0]))
            s = model.samplers[t.sampler_index] if model.samplers else None
            modes.append((
                1 if (s and s.mag_filter == FILTER_NEAREST) else 0,
                wrap_code(s.wrap_s) if s else 0,
                wrap_code(s.wrap_t) if s else 0))
        max_h = max(i.shape[0] for i in imgs)
        max_w = max(i.shape[1] for i in imgs)
        stacked = np.zeros((len(imgs), max_h, max_w, 4), np.float32)
        for i, img in enumerate(imgs):
            stacked[i, :img.shape[0], :img.shape[1]] = img
        texture_sizes = np.array(sizes, np.int32)
        texture_modes = np.array(modes, np.int32)
    else:
        stacked = np.ones((1, 1, 1, 4), np.float32)
        texture_sizes = np.array([[1, 1]], np.int32)
        texture_modes = np.zeros((1, 3), np.int32)
    default_samplers_only = bool((texture_modes == 0).all())

    # quad-packed bilinear windows (Scene.textures_quad docstring): repeat
    # wrapping baked per texture's OWN size inside the padded stack
    quad = None
    if default_samplers_only and model.images and model.textures:
        quad = np.zeros(stacked.shape[:3] + (16,), np.float32)
        for i, img in enumerate(imgs):
            hi, wi = img.shape[:2]
            xp = np.roll(img, -1, axis=1)
            yp = np.roll(img, -1, axis=0)
            xyp = np.roll(yp, -1, axis=1)
            quad[i, :hi, :wi] = np.concatenate(
                [img, xp, yp, xyp], axis=-1)
        quad = quad.reshape(-1, 16)

    if skybox is None:
        skybox = np.zeros((1, 1, 3), np.float32)

    # packed fetch tables (Scene docstring): wide rows so the hot shade path
    # is a handful of row gathers instead of ~20 narrow ones
    v = model.positions.shape[0]
    vertex_attrs = np.zeros((max(v, 1), 16), np.float32)
    if v:
        vertex_attrs[:, 0:3] = model.normals[:, :3]
        vertex_attrs[:, 3:5] = model.uvs[:, :2]
        vertex_attrs[:, 5:9] = model.colors[:, :4]
    tri_vertex_ids = (np.concatenate(tri_vids, axis=0) if tri_vids
                      else np.zeros((0, 3), np.int32))
    geom_rows = np.zeros((max(g, 1), 32), np.float32)
    if g:
        geom_rows[:, 0:9] = transforms[:, :3, :3].reshape(g, 9)
        geom_rows[:, 9:12] = base_colors[:, :3]
        geom_rows[:, 12] = tex_idx.astype(np.float32)
        geom_rows[:, 13] = metallic
        geom_rows[:, 14:17] = emission[:, :3]
        geom_rows[:, 17] = roughness

    return Scene(
        positions=jnp.asarray(model.positions),
        normals=jnp.asarray(model.normals),
        colors=jnp.asarray(model.colors),
        uvs=jnp.asarray(model.uvs),
        indices=jnp.asarray(model.indices, jnp.uint32),
        geometry=GeometryTable(
            transform=jnp.asarray(transforms),
            base_color=jnp.asarray(base_colors),
            base_color_texture_index=jnp.asarray(tex_idx),
            metallic_factor=jnp.asarray(metallic),
            index_offset=jnp.asarray(index_offsets),
            vertex_offset=jnp.asarray(vertex_offsets),
            emission=jnp.asarray(emission),
            roughness=jnp.asarray(roughness),
        ),
        tri_v0=jnp.asarray(tri_v0),
        tri_edge1=jnp.asarray(tri_e1),
        tri_edge2=jnp.asarray(tri_e2),
        tri_geometry=jnp.asarray(tri_geo),
        tri_primitive=jnp.asarray(tri_prim),
        textures=jnp.asarray(stacked),
        texture_sizes=jnp.asarray(texture_sizes),
        texture_modes=jnp.asarray(texture_modes),
        skybox=jnp.asarray(skybox, jnp.float32),
        tri_attrs=jnp.asarray(np.concatenate(
            [vertex_attrs[tri_vertex_ids.reshape(-1)].reshape(-1, 48),
             geom_rows[np.asarray(tri_geo, np.int64)]], axis=1)),
        geom_rows=jnp.asarray(geom_rows),
        geom_tri_base=jnp.asarray(tri_bases),
        num_triangles=int(tri_v0.shape[0]),
        num_geometries=g,
        num_emissive_triangles=num_lights,
        default_samplers_only=default_samplers_only,
        has_textures=bool(model.images and model.textures),
        host_tri_v0=np.asarray(tri_v0, np.float32),
        host_tri_edge1=np.asarray(tri_e1, np.float32),
        host_tri_edge2=np.asarray(tri_e2, np.float32),
        host_emission=emission,
        host_tri_geometry=np.asarray(tri_geo, np.int32),
        textures_quad=(jnp.asarray(quad) if quad is not None else None),
    )


# ---------------------------------------------------------------------------
# Texture / environment sampling
# ---------------------------------------------------------------------------

def sample_texture_bilinear(textures: jax.Array, sizes: jax.Array,
                            tex_index: jax.Array, uv: jax.Array,
                            modes: jax.Array | None = None,
                            quad: jax.Array | None = None) -> jax.Array:
    """Sample the stacked texture array honoring per-texture sampler state.

    textures: [NT, H, W, 4]; tex_index: [...]; uv: [..., 2] -> [..., 4].
    modes: optional [NT, 3] i32 (nearest, wrap_s, wrap_t) from
    Scene.texture_modes (ref: gltf/texture.rs:1-118 sampler table); None
    falls back to the default glTF sampler (repeat + linear,
    gltf/mod.rs:147-152). Nearest filtering reuses the bilinear gathers
    with the fraction forced to the texel center (no extra loads).

    quad: optional Scene.textures_quad [NT*H*W, 16] — the whole 2x2
    bilinear window in ONE row gather instead of four (bit-exact for the
    default repeat sampler because (x0+1) mod w == (x0 mod w)+1 mod w;
    clamp/mirror break that identity at borders, so modes != None keeps
    the 4-gather path)."""
    ti = jnp.maximum(tex_index, 0)
    w = sizes[ti, 0].astype(jnp.float32)
    h = sizes[ti, 1].astype(jnp.float32)
    if modes is not None:
        nearest = modes[ti, 0] != 0
        wrap_s = modes[ti, 1]
        wrap_t = modes[ti, 2]
    else:
        nearest = jnp.zeros(ti.shape, bool)
        wrap_s = jnp.zeros(ti.shape, jnp.int32)
        wrap_t = jnp.zeros(ti.shape, jnp.int32)

    # pixel-center sampling: uv*size - 0.5 (linear); floor(uv*size) with a
    # zero fraction reproduces nearest filtering exactly
    x = jnp.where(nearest, jnp.floor(uv[..., 0] * w), uv[..., 0] * w - 0.5)
    y = jnp.where(nearest, jnp.floor(uv[..., 1] * h), uv[..., 1] * h - 0.5)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap(v, n, mode):
        v = v.astype(jnp.int32)
        n = jnp.maximum(n.astype(jnp.int32), 1)
        repeat = jnp.mod(v, n)
        clamp = jnp.clip(v, 0, n - 1)
        p = jnp.mod(v, 2 * n)  # sign of divisor: already non-negative
        mirror = jnp.where(p >= n, 2 * n - 1 - p, p)
        return jnp.where(mode == 1, clamp, jnp.where(mode == 2, mirror,
                                                     repeat))

    nt, hh, ww, _ = textures.shape
    base = ti * (hh * ww)
    x0i = wrap(x0, w, wrap_s)
    y0i = wrap(y0, h, wrap_t)
    if quad is not None and modes is None:
        r = quad[base + y0i * ww + x0i]  # [..., 16]: the 2x2 window
        c00, c10 = r[..., 0:4], r[..., 4:8]
        c01, c11 = r[..., 8:12], r[..., 12:16]
    else:
        # flat-index row gathers: one index per row instead of the 4D
        # textures[ti, y, x] multi-index gather
        x1i = wrap(x0 + 1, w, wrap_s)
        y1i = wrap(y0 + 1, h, wrap_t)
        flat = textures.reshape(nt * hh * ww, 4)
        c00 = flat[base + y0i * ww + x0i]
        c10 = flat[base + y0i * ww + x1i]
        c01 = flat[base + y1i * ww + x0i]
        c11 = flat[base + y1i * ww + x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_equirect(skybox: jax.Array, uv: jax.Array) -> jax.Array:
    """Bilinear equirect sample, wrap in u / clamp in v
    (SkyBox sampler, main.rs:123-129 uses clamp-to-border; we clamp-to-edge
    which only differs on the 1-texel border)."""
    h, w = skybox.shape[0], skybox.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    c00 = skybox[y0i, x0i]
    c10 = skybox[y0i, x1i]
    c01 = skybox[y1i, x0i]
    c11 = skybox[y1i, x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def get_environment_radiance(scene: Scene, direction: jax.Array,
                             environment: int) -> jax.Array:
    """(ref: RtxdiApplicationBridge.glsl:618-627)."""
    if not environment:
        return jnp.zeros(direction.shape[:-1] + (3,), direction.dtype)
    from raytracer2.utils.brdf import direction_to_equirect_uv

    return sample_equirect(scene.skybox, direction_to_equirect_uv(direction))


# ---------------------------------------------------------------------------
# Geometry / material fetch (ref: Hit.glsl)
# ---------------------------------------------------------------------------

class SurfaceGeometry(NamedTuple):
    """Interpolated hit attributes (outputs of Hit.glsl:2-42)."""

    normal: jax.Array  # [..., 3]
    specular_f0: jax.Array  # [..., 3]
    roughness: jax.Array  # [...]
    diffuse_albedo: jax.Array  # [..., 3]
    emission: jax.Array  # [..., 3]
    uv: jax.Array  # [..., 2] texture coords (for debugging)


def get_geometry_from_hit(
    scene: Scene,
    geometry_index: jax.Array,  # [...] int32
    primitive_id: jax.Array,  # [...] int32
    attribs: jax.Array,  # [..., 2] barycentric hit uv
    textures_enabled: bool = True,
    roughness_override: float | None = ROUGHNESS_OVERRIDE,
    emission_scale: float = EMISSION_SCALE,
    triangle_index: jax.Array | None = None,
) -> SurfaceGeometry:
    """Vectorized port of GetGeometryFromHit (Hit.glsl:2-42).

    Gathers the three vertices of the hit triangle, interpolates
    normal/uv/color, transforms the normal by the node matrix (Hit.glsl:27 —
    no inverse transpose, quirk preserved), samples the base-color texture,
    and applies the reference's roughness=1.0 / emission*12 quirks.

    triangle_index: the world-triangle id when the caller already has it
    (HitRecord carries it) — the whole material fetch then collapses to
    ONE [T, 80]-row gather (Scene.tri_attrs docstring). Values on lanes
    with invalid ids are junk either way; callers mask by `missed`.
    """
    # 4K-class batches: the [N, 80] fetch output alone is 2.65 GB at
    # 8.3M lanes — chunk the fetch when the batch is larger than any
    # 1080p working set to bound peak device memory; smaller batches keep
    # the one-shot form
    n_total = int(np.prod(geometry_index.shape)) if geometry_index.ndim \
        else 1
    if n_total > (1 << 22):
        chunk = 1 << 21
        shape = geometry_index.shape
        nc = (n_total + chunk - 1) // chunk
        pad = nc * chunk - n_total

        def flat(a):
            f = a.reshape((n_total,) + a.shape[len(shape):])
            if pad:
                f = jnp.concatenate(
                    [f, jnp.zeros((pad,) + f.shape[1:], f.dtype)])
            return f.reshape((nc, chunk) + f.shape[1:])

        args = (flat(geometry_index), flat(primitive_id), flat(attribs),
                (flat(triangle_index) if triangle_index is not None
                 else None))

        def one(a):
            gi_c, pi_c, at_c, tri_c = a
            return get_geometry_from_hit(
                scene, gi_c, pi_c, at_c,
                textures_enabled=textures_enabled,
                roughness_override=roughness_override,
                emission_scale=emission_scale,
                triangle_index=tri_c)

        out = jax.lax.map(one, args)
        return SurfaceGeometry(*(
            leaf.reshape((nc * chunk,) + leaf.shape[2:])[:n_total]
            .reshape(shape + leaf.shape[2:]) for leaf in out))

    if triangle_index is not None:
        tri = jnp.clip(triangle_index, 0, scene.num_triangles - 1)
    else:
        gi = jnp.maximum(geometry_index, 0)
        tri = scene.geom_tri_base[gi] + primitive_id
        tri = jnp.clip(tri, 0, scene.num_triangles - 1)
    ta = scene.tri_attrs[tri]  # [..., 80] — the ONLY row gather
    grow = ta[..., 48:80]
    a0 = ta[..., 0:16]
    a1 = ta[..., 16:32]
    a2 = ta[..., 32:48]

    b0 = (1.0 - attribs[..., 0] - attribs[..., 1])[..., None]
    b1 = attribs[..., 0:1]
    b2 = attribs[..., 1:2]
    a = a0 * b0 + a1 * b1 + a2 * b2  # interpolate all attributes at once

    n = v_normalize(a[..., 0:3])
    t33 = grow[..., 0:9].reshape(grow.shape[:-1] + (3, 3))
    # node-matrix transform, no inverse transpose (Hit.glsl:27 quirk)
    n = v_normalize(jnp.einsum("...ij,...j->...i", t33, n,
                               precision=jax.lax.Precision.HIGHEST))

    uv = a[..., 3:5]
    vcol = a[..., 5:8]
    color = grow[..., 9:12] * vcol

    tex_index = grow[..., 12].astype(jnp.int32)
    if textures_enabled and scene.has_textures:
        texel = sample_texture_bilinear(
            scene.textures, scene.texture_sizes, tex_index, uv,
            modes=(None if scene.default_samplers_only
                   else scene.texture_modes),
            quad=(scene.textures_quad if scene.default_samplers_only
                  else None))[..., :3]
        color = jnp.where((tex_index > -1)[..., None], color * texel, color)

    metallic = grow[..., 13:14]
    specular_f0 = color * metallic  # mix(0, color, metallic) (Hit.glsl:39)
    if roughness_override is not None:
        rough = jnp.full(color.shape[:-1], roughness_override, color.dtype)
    else:
        rough = grow[..., 17]
    emission = grow[..., 14:17] * emission_scale

    return SurfaceGeometry(
        normal=n, specular_f0=specular_f0, roughness=rough,
        diffuse_albedo=color, emission=emission, uv=uv)
