"""ReGIR: world-space light presampling — grid AND onion layouts.

Port of rtxdi/ReGIR.h + ReGIRSampling.hlsli + the grid build pass
(PresamplingFunctions.hlsli:168-249). The reference ships this code but
compiles it out (RTXDI_REGIR_DISABLED) and the host never enables it
(SURVEY.md §2.3); the rebuild provides both layouts as working
capabilities — each cell holds `lights_per_cell` RIS-selected lights
weighted by their contribution to the cell volume, and local-light
sampling mode 2 draws candidates from the surface's (jittered) cell.

Grid: regular cellsX*cellsY*cellsZ lattice (ReGIRSampling.hlsli:14-61).
Onion: concentric log-spaced spherical shells of latitude rings whose
cell size grows with distance from the center (ReGIRSampling.hlsli:
64-215) — constant RELATIVE resolution, the layout meant for cameras
inside large scenes. The reference ships only the DECLARATION of the
onion table builder (ReGIR.h:160 `InitializeOnion` has no
implementation anywhere in the repo), so build_onion_layout here is an
original construction built to satisfy the shipped cell-indexing math:
ring 0 on the equator, rings i>0 duplicated for +-elevation, ~isotropic
cells (azimuthal arc ~ radial thickness ~ r*(layerScale-1))."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from raytracer2.lights.polymorphic import (
    LightInfo, get_light_type, unpack_light_color, _create_triangle,
    K_POINT, K_TRIANGLE)
from raytracer2.params import LightBufferRegion
from raytracer2.utils import brdf
from raytracer2.utils import rng as rtrng


@dataclasses.dataclass(frozen=True)
class OnionLayout:
    """ReGIR_OnionParameters analogue (rtxdi/ReGIRParameters.h:27-94):
    host-built layer-group + ring tables, all static python tuples (they
    fold into the compiled program as constants)."""

    # per layer group
    inner_radius: tuple      # float — group's innermost shell radius
    layer_scale: tuple       # float — radial ratio between layers
    layer_count: tuple       # int
    equatorial_cell_angle: tuple  # float
    ring_offset: tuple       # int — first ring in the flat ring tables
    ring_count: tuple        # int
    cells_per_layer: tuple   # int
    layer_cell_offset: tuple  # int — global cell index of the group
    # flat ring tables (all groups concatenated)
    ring_cell_angle: tuple   # float
    ring_cell_offset: tuple  # int — offset within the layer
    ring_cell_count: tuple   # int
    # jitter curve (ReGIRSampling.hlsli:66-79)
    cubic_root_factor: float
    linear_factor: float
    num_cells: int

    @property
    def outer_radius(self) -> tuple:
        return tuple(r * s ** c for r, s, c in zip(
            self.inner_radius, self.layer_scale, self.layer_count))


def build_onion_layout(cell_size: float,
                       detail_layers: int = 5,
                       coverage_layers: int = 10,
                       detail_scale: float = 1.26,
                       coverage_scale: float = 1.6) -> OnionLayout:
    """Build the onion layer/ring tables (ReGIROnionStaticParameters
    defaults: 5 detail + 10 coverage layers, ReGIR.h:52-66; the SDK's
    builder is absent from the reference, see module docstring).

    Cell 0 is the center sphere of radius `cell_size`. Each group's
    equatorial cell angle equals its layerScale - 1, making cells
    ~isotropic (azimuthal arc r*angle ~ radial thickness r*(scale-1));
    ring i sits at elevation i*angle, rings i>0 appear at +-elevation
    with azimuthal counts shrinking by cos(elevation) so cells keep
    their equatorial arc length."""
    import math

    groups = [(detail_layers, detail_scale), (coverage_layers,
                                              coverage_scale)]
    inner_radius, layer_scale, layer_count = [], [], []
    eq_angle, ring_offset, ring_count = [], [], []
    cells_per_layer, layer_cell_offset = [], []
    r_angle, r_offset, r_count = [], [], []

    inner = cell_size
    next_cell = 1  # cell 0 = center sphere
    for n_layers, scale in groups:
        angle = scale - 1.0
        n_rings = int(math.pi / 2 / angle + 0.5) + 1
        inner_radius.append(inner)
        layer_scale.append(scale)
        layer_count.append(n_layers)
        eq_angle.append(angle)
        ring_offset.append(len(r_angle))
        ring_count.append(n_rings)
        off = 0
        for i in range(n_rings):
            elev = i * angle
            cnt = max(1, int(round(2.0 * math.pi
                                   * max(math.cos(elev), 1e-3) / angle)))
            r_angle.append(2.0 * math.pi / cnt)
            r_offset.append(off)
            r_count.append(cnt)
            off += cnt * (2 if i > 0 else 1)
        cells_per_layer.append(off)
        layer_cell_offset.append(next_cell)
        next_cell += off * n_layers
        inner *= scale ** n_layers

    # jitter curve (GetJitterScale, ReGIRSampling.hlsli:66-79): in the
    # coverage region cell extent grows ~linearly with r; the cubic-root
    # branch covers the detail region's slower growth
    linear = groups[-1][1] - 1.0
    cubic = 1.0
    return OnionLayout(
        inner_radius=tuple(inner_radius), layer_scale=tuple(layer_scale),
        layer_count=tuple(layer_count),
        equatorial_cell_angle=tuple(eq_angle),
        ring_offset=tuple(ring_offset), ring_count=tuple(ring_count),
        cells_per_layer=tuple(cells_per_layer),
        layer_cell_offset=tuple(layer_cell_offset),
        ring_cell_angle=tuple(r_angle), ring_cell_offset=tuple(r_offset),
        ring_cell_count=tuple(r_count),
        cubic_root_factor=cubic, linear_factor=linear,
        num_cells=next_cell)


@dataclasses.dataclass(frozen=True)
class ReGIRGridParameters:
    """ReGIR_CommonParameters + ReGIR_GridParameters (+ optional onion
    tables) — rtxdi/ReGIRParameters.h. All static."""

    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    cell_size: float = 1.0
    cells: tuple[int, int, int] = (16, 16, 16)
    lights_per_cell: int = 128
    sampling_jitter: float = 1.0
    num_build_samples: int = 8
    onion: OnionLayout | None = None  # set -> onion layout active

    @property
    def num_cells(self) -> int:
        if self.onion is not None:
            return self.onion.num_cells
        return self.cells[0] * self.cells[1] * self.cells[2]


def get_jitter_scale(params: ReGIRGridParameters, world_pos=None):
    """(ReGIRSampling.hlsli:16-19 grid / :66-79 onion: the onion jitter
    grows with distance from the center like the cells do)."""
    if params.onion is None or world_pos is None:
        return params.sampling_jitter * params.cell_size
    o = params.onion
    center = jnp.asarray(params.center, jnp.float32)
    d = jnp.linalg.norm(world_pos - center, axis=-1, keepdims=True) \
        / params.cell_size
    scale = jnp.maximum(1.0, jnp.maximum(
        jnp.cbrt(d) * o.cubic_root_factor, d * o.linear_factor))
    return scale * params.sampling_jitter * params.cell_size


def world_pos_to_cell_index(params: ReGIRGridParameters,
                            world_pos: jax.Array) -> jax.Array:
    """RTXDI_ReGIR_WorldPosToCellIndex (ReGIRSampling.hlsli:21-34 grid /
    :81-127 onion): [-1] outside the covered volume."""
    if params.onion is not None:
        return _onion_world_pos_to_cell_index(params, world_pos)
    center = jnp.asarray(params.center, jnp.float32)
    counts = jnp.asarray(params.cells, jnp.int32)
    origin = center - counts.astype(jnp.float32) * (params.cell_size * 0.5)
    cell = jnp.floor((world_pos - origin) / params.cell_size).astype(jnp.int32)
    inside = jnp.all((cell >= 0) & (cell < counts), axis=-1)
    idx = (cell[..., 0] + (cell[..., 1] + cell[..., 2] * counts[1])
           * counts[0])
    return jnp.where(inside, idx, -1)


def cell_index_to_world_pos(params: ReGIRGridParameters,
                            cell_index: jax.Array
                            ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """RTXDI_ReGIR_CellIndexToWorldPos (ReGIRSampling.hlsli:36-60 grid /
    :129-215 onion): (valid, center [..,3], radius)."""
    if params.onion is not None:
        return _onion_cell_index_to_world_pos(params, cell_index)
    center = jnp.asarray(params.center, jnp.float32)
    counts = jnp.asarray(params.cells, jnp.int32)
    origin = center - counts.astype(jnp.float32) * (params.cell_size * 0.5)
    x = cell_index % counts[0]
    y = (cell_index // counts[0]) % counts[1]
    z = cell_index // (counts[0] * counts[1])
    valid = (cell_index >= 0) & (z < counts[2])
    pos = (jnp.stack([x, y, z], axis=-1).astype(jnp.float32) + 0.5) \
        * params.cell_size + origin
    radius = jnp.full(cell_index.shape, params.cell_size * jnp.sqrt(3.0))
    return valid, pos, radius


def _onion_world_pos_to_cell_index(params: ReGIRGridParameters,
                                   world_pos: jax.Array) -> jax.Array:
    """(ReGIRSampling.hlsli:81-127), vectorized: the per-group branch
    becomes a static python loop over the (two) layer groups with a
    jnp.where select; ring tables gather by ringOffset + ringIndex."""
    o = params.onion
    center = jnp.asarray(params.center, jnp.float32)
    p = world_pos - center
    r = jnp.linalg.norm(p, axis=-1)
    safe_r = jnp.maximum(r, 1e-20)
    # RTXDI_CartesianToSpherical (RtxdiMath.hlsli:81-88) + PI shift
    azimuth = jnp.arctan2(p[..., 2], p[..., 0]) + jnp.pi
    elevation = jnp.arcsin(jnp.clip(p[..., 1] / safe_r, -1.0, 1.0))

    ca = jnp.asarray(o.ring_cell_angle, jnp.float32)
    co = jnp.asarray(o.ring_cell_offset, jnp.int32)
    cc = jnp.asarray(o.ring_cell_count, jnp.int32)

    idx = jnp.full(r.shape, -1, jnp.int32)
    for g in reversed(range(len(o.layer_count))):
        inner = o.inner_radius[g]
        scale = o.layer_scale[g]
        layer = jnp.floor(jnp.maximum(
            0.0, jnp.log(safe_r / inner) / jnp.log(scale))).astype(jnp.int32)
        layer = jnp.minimum(layer, o.layer_count[g] - 1)  # numeric guard
        ring = jnp.floor(jnp.abs(elevation)
                         / o.equatorial_cell_angle[g] + 0.5).astype(jnp.int32)
        ring = jnp.clip(ring, 0, o.ring_count[g] - 1)
        rr = o.ring_offset[g] + ring
        cell_angle = ca[rr]
        az = jnp.where((layer & 1) != 0, azimuth - cell_angle * 0.5, azimuth)
        az = jnp.where(az < 0, az + 2.0 * jnp.pi, az)
        cell = jnp.minimum((az / cell_angle).astype(jnp.int32), cc[rr] - 1)
        ring_cell_offset = co[rr] + jnp.where(
            (elevation < 0) & (ring > 0), cc[rr], 0)
        cand = (cell + ring_cell_offset + layer * o.cells_per_layer[g]
                + o.layer_cell_offset[g])
        in_group = r <= inner * scale ** o.layer_count[g]
        idx = jnp.where(in_group, cand, idx)
    return jnp.where(r <= o.inner_radius[0], 0, idx)


def _onion_cell_index_to_world_pos(params: ReGIRGridParameters,
                                   cell_index: jax.Array
                                   ) -> tuple[jax.Array, jax.Array,
                                              jax.Array]:
    """(ReGIRSampling.hlsli:129-215), vectorized; the ring walk becomes a
    searchsorted over each group's precomputed ring-end table."""
    import numpy as np

    o = params.onion
    center = jnp.asarray(params.center, jnp.float32)
    shape = cell_index.shape

    pos = jnp.zeros(shape + (3,), jnp.float32)
    radius = jnp.zeros(shape, jnp.float32)

    for g in range(len(o.layer_count)):
        r0, r1 = o.ring_offset[g], o.ring_offset[g] + o.ring_count[g]
        cnt = np.asarray(o.ring_cell_count[r0:r1])
        offs = np.asarray(o.ring_cell_offset[r0:r1])
        ends = offs + cnt * np.where(np.arange(len(cnt)) > 0, 2, 1)
        ci = cell_index - o.layer_cell_offset[g]
        layer = ci // o.cells_per_layer[g]
        rem = ci - layer * o.cells_per_layer[g]
        ring = jnp.searchsorted(jnp.asarray(ends), rem, side="right")
        ring = jnp.clip(ring, 0, o.ring_count[g] - 1)
        cell_angle = jnp.asarray(o.ring_cell_angle, jnp.float32)[r0 + ring]
        cell_cnt = jnp.asarray(o.ring_cell_count, jnp.int32)[r0 + ring]
        cell = rem - jnp.asarray(o.ring_cell_offset, jnp.int32)[r0 + ring]
        eq = o.equatorial_cell_angle[g]
        elevation = ring.astype(jnp.float32) * eq
        elevation = jnp.where(cell >= cell_cnt, -elevation, elevation)
        az = (cell.astype(jnp.float32) + 0.5) * cell_angle
        az = jnp.where((layer & 1) != 0, az + cell_angle * 0.5, az)
        az = az - jnp.pi
        layer_inner = o.inner_radius[g] * o.layer_scale[g] ** \
            layer.astype(jnp.float32)
        layer_outer = layer_inner * o.layer_scale[g]
        rmid = (layer_inner + layer_outer) * 0.5

        def sph(rr, a, e):
            # RTXDI_SphericalToCartesian (RtxdiMath.hlsli:90-101)
            return jnp.stack([rr * jnp.cos(a) * jnp.cos(e),
                              rr * jnp.sin(e),
                              rr * jnp.sin(a) * jnp.cos(e)], axis=-1)

        cell_center = sph(rmid, az, elevation)
        az_c = az + cell_angle * 0.5
        elev_c = jnp.where(elevation == 0, eq * 0.5,
                           (jnp.abs(elevation) - eq * 0.5)
                           * jnp.sign(elevation))
        corner = sph(layer_outer, az_c, elev_c)
        rad = jnp.linalg.norm(corner - cell_center, axis=-1)

        sel = ((cell_index >= o.layer_cell_offset[g])
               & (ci < o.cells_per_layer[g] * o.layer_count[g]))
        pos = jnp.where(sel[..., None], cell_center, pos)
        radius = jnp.where(sel, rad, radius)

    is_center = cell_index == 0
    radius = jnp.where(is_center, o.inner_radius[0], radius)
    valid = (cell_index >= 0) & (cell_index < o.num_cells)
    return valid, jnp.where(valid[..., None], pos + center, 0.0), \
        jnp.where(valid, radius, 0.0)


# ---------------------------------------------------------------------------
# Light weight for a volume (PolymorphicLight.glsl:473-490)
# ---------------------------------------------------------------------------

def _average_distance_to_volume(distance, radius):
    """(PolymorphicLight.glsl:129-139)."""
    nonlinear = 1.1547
    return distance + radius * radius ** 2 / jnp.maximum(
        (distance + radius * nonlinear) ** 2, 1e-20)


def get_light_weight_for_volume(info: LightInfo, volume_center: jax.Array,
                                volume_radius) -> jax.Array:
    """RAB_GetLightTargetPdfForVolume (bridge:504-507 ->
    PolymorphicLight.glsl:473-490), incl. the shaped-light sphere-cone cull
    (PolymorphicLight.glsl:175-178)."""
    from raytracer2.lights.polymorphic import get_shaping
    from raytracer2.lights.shaping import (
        test_sphere_intersection_for_shaped_light)

    ltype = get_light_type(info.color_type_and_flags)

    # point lights (:175-184)
    flux = unpack_light_color(info)
    d_point = jnp.linalg.norm(volume_center - info.center, axis=-1)
    d_point = _average_distance_to_volume(d_point, volume_radius)
    w_point = brdf.luminance(flux) / jnp.maximum(d_point ** 2, 1e-20)
    cone_ok = test_sphere_intersection_for_shaped_light(
        info.center, 0.0, get_shaping(info), volume_center, volume_radius)
    w_point = jnp.where(cone_ok, w_point, 0.0)

    # triangle lights (:302-316)
    tri = _create_triangle(info)
    dist_to_plane = brdf.dot3(volume_center - tri.base, tri.normal)
    barycenter = tri.base + (tri.edge1 + tri.edge2) / 3.0
    d_tri = jnp.linalg.norm(barycenter - volume_center, axis=-1)
    d_tri = _average_distance_to_volume(d_tri, volume_radius)
    solid_angle = jnp.minimum(
        tri.surface_area / jnp.maximum(d_tri ** 2, 1e-20), 2.0 * brdf.PI)
    w_tri = jnp.where(dist_to_plane < -volume_radius, 0.0,
                      solid_angle * brdf.luminance(tri.radiance))

    w = jnp.where(ltype == K_POINT, w_point, 0.0)
    return jnp.where(ltype == K_TRIANGLE, w_tri, w)


# ---------------------------------------------------------------------------
# Grid build (PresamplingFunctions.hlsli:168-249)
# ---------------------------------------------------------------------------

def presample_regir_grid(
    rng_seed: int,
    lights: LightInfo,
    local_region: LightBufferRegion,
    params: ReGIRGridParameters,
) -> jax.Array:
    """Fill the ReGIR RIS buffer: [num_cells * lights_per_cell, 2] u32 of
    (light index, RIS weight bits). One RIS stream per light slot, each
    drawing `num_build_samples` uniform candidates weighted by the light's
    contribution to the slot's cell volume."""
    n_slots = params.num_cells * params.lights_per_cell
    slot = jnp.arange(n_slots, dtype=jnp.uint32)
    cell_index = (slot // params.lights_per_cell).astype(jnp.int32)
    valid_cell, cell_center, cell_radius = cell_index_to_world_pos(
        params, cell_index)
    cell_radius = cell_radius * (params.sampling_jitter + 1.0)  # (:196)

    state = rtrng.RngState(seed=rtrng.jenkins_hash(slot) + jnp.uint32(rng_seed),
                           index=jnp.ones_like(slot))

    num_lights = max(local_region.num_lights, 1)
    inv_num_samples = 1.0 / max(params.num_build_samples, 1)

    selected = jnp.zeros((n_slots,), jnp.uint32)
    selected_pdf = jnp.zeros((n_slots,), jnp.float32)
    weight_sum = jnp.zeros((n_slots,), jnp.float32)

    for _ in range(params.num_build_samples):
        r, state = rtrng.sample_uniform(state)
        light_index = (local_region.first_light_index + jnp.minimum(
            (r * num_lights).astype(jnp.uint32), num_lights - 1))
        info = LightInfo(*(leaf[light_index.astype(jnp.int32)]
                           for leaf in lights))
        target = get_light_weight_for_volume(info, cell_center, cell_radius)
        inv_source_pdf = float(num_lights) * inv_num_samples
        ris_w = target * inv_source_pdf
        weight_sum = weight_sum + ris_w
        rr, state = rtrng.sample_uniform(state)
        take = rr * weight_sum < ris_w
        selected = jnp.where(take, light_index, selected)
        selected_pdf = jnp.where(take, target, selected_pdf)

    weight = jnp.where(selected_pdf > 0.0,
                       weight_sum / jnp.maximum(selected_pdf, 1e-30), 0.0)
    weight = jnp.where(valid_cell & (local_region.num_lights > 0),
                       weight, 0.0)
    return jnp.stack(
        [jnp.where(weight > 0, selected, jnp.uint32(0)),
         jax.lax.bitcast_convert_type(weight, jnp.uint32)], axis=-1)


def select_light_from_regir_cell(
    rng: rtrng.RngState,
    ris_buffer: jax.Array,  # [num_cells * lights_per_cell, 2]
    cell_index: jax.Array,  # [...] int32 (-1 = no cell)
    params: ReGIRGridParameters,
) -> tuple[jax.Array, jax.Array, jax.Array, rtrng.RngState]:
    """RTXDI_SelectLocalLightReGIRRISTile + tile draw: returns
    (light_index, inv_source_pdf, valid, rng)."""
    r, rng = rtrng.sample_uniform(rng)
    in_cell = jnp.minimum((r * params.lights_per_cell).astype(jnp.int32),
                          params.lights_per_cell - 1)
    ptr = jnp.maximum(cell_index, 0) * params.lights_per_cell + in_cell
    entry = ris_buffer[ptr]
    light_index = entry[..., 0]
    inv_pdf = jax.lax.bitcast_convert_type(entry[..., 1], jnp.float32)
    valid = (cell_index >= 0) & (inv_pdf > 0.0)
    return light_index, inv_pdf, valid, rng
