"""ReGIR world-space light grid tests (ref: ReGIRSampling.hlsli,
PresamplingFunctions.hlsli:168-249)."""

import numpy as np
import jax.numpy as jnp

from raytracer2.lights.polymorphic import store_triangle_lights
from raytracer2.params import LightBufferRegion
from raytracer2.restir import regir
from raytracer2.utils import rng as rtrng


PARAMS = regir.ReGIRGridParameters(
    center=(0.0, 0.0, 0.0), cell_size=2.0, cells=(4, 4, 4),
    lights_per_cell=32, num_build_samples=8)


def test_cell_index_roundtrip():
    pts = jnp.asarray(np.random.default_rng(0).uniform(-3.9, 3.9, (128, 3)),
                      jnp.float32)
    idx = regir.world_pos_to_cell_index(PARAMS, pts)
    assert np.all(np.asarray(idx) >= 0)
    valid, centers, radius = regir.cell_index_to_world_pos(PARAMS, idx)
    assert np.all(np.asarray(valid))
    # the point lies inside its cell
    d = np.abs(np.asarray(pts) - np.asarray(centers))
    assert np.all(d <= PARAMS.cell_size * 0.5 + 1e-4)
    np.testing.assert_allclose(np.asarray(radius), 2.0 * np.sqrt(3), rtol=1e-5)


def test_outside_grid_is_invalid():
    idx = regir.world_pos_to_cell_index(
        PARAMS, jnp.asarray([[100.0, 0.0, 0.0]]))
    assert int(idx[0]) == -1


def _make_lights(n=64, seed=1):
    rng = np.random.default_rng(seed)
    base = jnp.asarray(rng.uniform(-4, 4, (n, 3)), jnp.float32)
    e1 = jnp.asarray(rng.uniform(0.1, 0.5, (n, 3)), jnp.float32)
    e2 = jnp.asarray(rng.uniform(0.1, 0.5, (n, 3)), jnp.float32)
    rad = jnp.asarray(rng.uniform(1.0, 10.0, (n, 3)), jnp.float32)
    return store_triangle_lights(base, e1, e2, rad), np.asarray(base)


def test_grid_build_prefers_nearby_lights():
    lights, base = _make_lights()
    region = LightBufferRegion(first_light_index=0, num_lights=64)
    buf = np.asarray(regir.presample_regir_grid(7, lights, region, PARAMS))
    assert buf.shape == (PARAMS.num_cells * PARAMS.lights_per_cell, 2)
    weights = buf[:, 1].view(np.float32)
    assert np.isfinite(weights).all() and (weights >= 0).all()
    assert (weights > 0).mean() > 0.5  # most slots found a light

    # slots of a cell should prefer lights near that cell: check mean
    # distance from slot-selected lights to their cell vs random assignment
    cell_idx = np.arange(buf.shape[0]) // PARAMS.lights_per_cell
    _, centers, _ = regir.cell_index_to_world_pos(
        PARAMS, jnp.asarray(cell_idx, jnp.int32))
    centers = np.asarray(centers)
    chosen = buf[:, 0].astype(np.int64)
    live = weights > 0
    d_sel = np.linalg.norm(base[chosen[live]] - centers[live], axis=-1).mean()
    d_rand = np.linalg.norm(
        base[np.random.default_rng(3).integers(0, 64, live.sum())]
        - centers[live], axis=-1).mean()
    assert d_sel < d_rand


def test_select_from_cell():
    lights, _ = _make_lights()
    region = LightBufferRegion(0, 64)
    buf = regir.presample_regir_grid(7, lights, region, PARAMS)
    pts = jnp.asarray([[0.0, 0.0, 0.0], [3.0, -3.0, 1.0]], jnp.float32)
    cells = regir.world_pos_to_cell_index(PARAMS, pts)
    state = rtrng.RngState(seed=jnp.uint32([1, 2]), index=jnp.uint32([1, 1]))
    idx, inv_pdf, valid, state = regir.select_light_from_regir_cell(
        state, buf, cells, PARAMS)
    assert np.asarray(valid).all()
    assert np.all(np.asarray(idx) < 64)
    assert np.all(np.asarray(inv_pdf) > 0)


# ---------------------------------------------------------------------------
# Onion layout (ReGIRSampling.hlsli:64-215; table builder is original —
# the reference declares InitializeOnion but ships no implementation)
# ---------------------------------------------------------------------------

ONION = regir.ReGIRGridParameters(
    center=(1.0, -2.0, 3.0), cell_size=0.5, lights_per_cell=32,
    num_build_samples=8,
    onion=regir.build_onion_layout(0.5, detail_layers=3,
                                   coverage_layers=6))


def test_onion_cell_count_and_center():
    o = ONION.onion
    assert o.num_cells == ONION.num_cells > 1
    # the center sphere is cell 0
    idx = regir.world_pos_to_cell_index(
        ONION, jnp.asarray([[1.0, -2.0, 3.0], [1.1, -2.0, 3.0]]))
    assert np.asarray(idx).tolist() == [0, 0]
    valid, c, r = regir.cell_index_to_world_pos(ONION, jnp.asarray([0]))
    assert bool(np.asarray(valid)[0])
    np.testing.assert_allclose(np.asarray(c)[0], [1.0, -2.0, 3.0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(r)[0], o.inner_radius[0])


def test_onion_encode_decode_consistency():
    """Every in-volume point maps to a valid cell whose decoded center
    lies in the same cell (encode(decode(encode(p))) == encode(p)) and
    within ~2 cell radii of the point."""
    o = ONION.onion
    outer = o.outer_radius[-1]
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(512, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= rng.uniform(0.01, outer * 0.999, (512, 1))
    pts = jnp.asarray(pts + np.asarray(ONION.center), jnp.float32)

    idx = np.asarray(regir.world_pos_to_cell_index(ONION, pts))
    assert np.all(idx >= 0)
    assert np.all(idx < o.num_cells)
    valid, centers, radius = regir.cell_index_to_world_pos(
        ONION, jnp.asarray(idx))
    assert np.all(np.asarray(valid))
    # decoded centers re-encode to the same cell
    idx2 = np.asarray(regir.world_pos_to_cell_index(ONION, centers))
    frac = np.mean(idx2 == idx)
    assert frac > 0.98, f"only {frac:.3f} of centers re-encode"  # fp ties
    # the point lies within the cell's bounding radius (with slack for
    # the corner-distance metric)
    d = np.linalg.norm(np.asarray(pts) - np.asarray(centers), axis=-1)
    ok = d <= np.asarray(radius) * 2.0 + 1e-3
    assert np.mean(ok) > 0.99, f"{np.mean(ok):.3f} within radius"


def test_onion_outside_returns_minus_one():
    o = ONION.onion
    far = jnp.asarray([[1.0, -2.0, 3.0 + o.outer_radius[-1] * 1.5]])
    assert int(np.asarray(regir.world_pos_to_cell_index(ONION, far))[0]) == -1
    v, _, _ = regir.cell_index_to_world_pos(ONION, jnp.asarray([-1]))
    assert not bool(np.asarray(v)[0])


def test_onion_presample_and_select():
    v0 = jnp.asarray([[0.5, -2.0, 3.0], [1.5, -1.6, 3.2]], jnp.float32)
    e1 = jnp.tile(jnp.asarray([[0.4, 0.0, 0.0]], jnp.float32), (2, 1))
    e2 = jnp.tile(jnp.asarray([[0.0, 0.4, 0.0]], jnp.float32), (2, 1))
    rad = jnp.tile(jnp.asarray([[4.0, 4.0, 4.0]], jnp.float32), (2, 1))
    lights = store_triangle_lights(v0, e1, e2, rad)
    region = LightBufferRegion(first_light_index=0, num_lights=2)
    buf = regir.presample_regir_grid(7, lights, region, ONION)
    assert buf.shape == (ONION.num_cells * ONION.lights_per_cell, 2)
    w = np.asarray(jnp.abs(
        jnp.asarray(np.asarray(buf)[:, 1]).view(jnp.float32)
        if hasattr(jnp.asarray(buf)[:, 1], "view") else buf[:, 1]))
    # cells near the lights carry nonzero weights
    pts = jnp.asarray([[0.6, -1.9, 3.0]], jnp.float32)
    cell = regir.world_pos_to_cell_index(ONION, pts)
    st = rtrng.RngState(seed=jnp.asarray([7], jnp.uint32),
                        index=jnp.asarray([1], jnp.uint32))
    li, inv_pdf, valid, st = regir.select_light_from_regir_cell(
        st, buf, cell, ONION)
    assert bool(np.asarray(valid)[0])
    assert int(np.asarray(li)[0]) in (0, 1)
    assert float(np.asarray(inv_pdf)[0]) > 0.0
