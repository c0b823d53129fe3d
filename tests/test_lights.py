"""Light subsystem tests: polymorphic records, prepare pass, PDF textures
(ref: PolymorphicLight.glsl, prepare_lights.comp, PresamplingFunctions.hlsli)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer2.lights import pdf_texture, polymorphic as pl
from raytracer2.lights.prepare import prepare_lights
from raytracer2.models import procedural as proc
from raytracer2.params import RTXDI_INVALID_LIGHT_INDEX
from raytracer2.scene import gltf
from raytracer2.scene.scene import build_scene
from raytracer2.utils import rng as rtrng


class TestLightColorPacking:
    def test_roundtrip_hdr(self):
        rng = np.random.default_rng(1)
        radiance = jnp.asarray(
            rng.uniform(0.1, 1.0, (64, 3))
            * np.exp(rng.uniform(np.log(1e-2), np.log(1e6), (64, 1))),
            jnp.float32)
        color_bits, log_r = pl.pack_light_color(radiance)
        info = pl.empty_light_info(64)._replace(
            color_type_and_flags=color_bits, log_radiance=log_r)
        back = np.asarray(pl.unpack_light_color(info))
        rel = np.abs(back - np.asarray(radiance)) / (np.asarray(radiance) + 1e-9)
        assert np.median(rel) < 0.02

    def test_zero_radiance(self):
        color_bits, log_r = pl.pack_light_color(jnp.zeros((1, 3)))
        info = pl.empty_light_info(1)._replace(
            color_type_and_flags=color_bits, log_radiance=log_r)
        np.testing.assert_array_equal(np.asarray(pl.unpack_light_color(info)),
                                      0.0)


class TestTriangleLights:
    def _tri(self):
        base = jnp.asarray([[0.0, 5.0, 0.0]])
        e1 = jnp.asarray([[2.0, 0.0, 0.0]])
        e2 = jnp.asarray([[0.0, 0.0, 2.0]])
        rad = jnp.asarray([[10.0, 8.0, 6.0]])
        return base, e1, e2, rad

    def test_store_roundtrip(self):
        base, e1, e2, rad = self._tri()
        info = pl.store_triangle_lights(base, e1, e2, rad)
        assert int(pl.get_light_type(info.color_type_and_flags)[0]) \
            == pl.K_TRIANGLE
        tri = pl._create_triangle(info)
        np.testing.assert_allclose(np.asarray(tri.base), np.asarray(base),
                                   atol=1e-2)
        np.testing.assert_allclose(np.asarray(tri.edge1), np.asarray(e1),
                                   atol=1e-2)
        np.testing.assert_allclose(np.asarray(tri.surface_area), 2.0,
                                   rtol=1e-2)
        np.testing.assert_allclose(np.asarray(tri.radiance), np.asarray(rad),
                                   rtol=0.05)

    def test_sample_on_triangle(self):
        base, e1, e2, rad = self._tri()
        info = pl.store_triangle_lights(base, e1, e2, rad)
        info_b = pl.LightInfo(*(jnp.repeat(l, 256, axis=0) for l in info))
        uv = jnp.asarray(np.random.default_rng(2).uniform(size=(256, 2)),
                         jnp.float32)
        viewer = jnp.zeros((256, 3))
        s = pl.calc_sample(info_b, uv, viewer)
        p = np.asarray(s.position)
        # sampled points lie in the triangle's plane y=5, inside bounds
        np.testing.assert_allclose(p[:, 1], 5.0, atol=0.05)
        assert np.all(p[:, 0] >= -0.05) and np.all(p[:, 0] <= 2.05)
        assert np.all(np.asarray(s.solid_angle_pdf) > 0)

    def test_power(self):
        base, e1, e2, rad = self._tri()
        info = pl.store_triangle_lights(base, e1, e2, rad)
        # power = area * pi * luminance (PolymorphicLight.glsl:297-300)
        from raytracer2.utils.brdf import luminance

        expected = 2.0 * np.pi * float(luminance(rad)[0])
        assert abs(float(pl.get_power(info)[0]) - expected) / expected < 0.05


class TestPointDirectionalEnv:
    def test_point_light_falloff(self):
        info = pl.store_point_lights(jnp.asarray([[0.0, 10.0, 0.0]]),
                                     jnp.asarray([[100.0, 100.0, 100.0]]))
        near = pl.calc_sample(info, jnp.zeros((1, 2)),
                              jnp.asarray([[0.0, 5.0, 0.0]]))
        far = pl.calc_sample(info, jnp.zeros((1, 2)),
                             jnp.asarray([[0.0, 0.0, 0.0]]))
        ratio = float(near.radiance[0, 0] / far.radiance[0, 0])
        assert abs(ratio - 4.0) < 0.1  # (10/5)^2

    def test_directional_sample(self):
        d = jnp.asarray([[0.0, -1.0, 0.0]])
        info = pl.store_directional_lights(
            d, jnp.asarray([[5.0, 5.0, 5.0]]), jnp.asarray([0.05]))
        s = pl.calc_sample(info, jnp.asarray([[0.3, 0.7]]),
                           jnp.zeros((1, 3)))
        # sample position is DISTANT_LIGHT_DISTANCE away opposite the light dir
        assert float(s.position[0, 1]) > 900.0
        assert float(s.solid_angle_pdf[0]) > 0

    def test_environment_importance_sample(self):
        info = pl.store_environment_light((128, 64), importance_sampled=True)
        sky = jnp.ones((64, 128, 3), jnp.float32) * 2.0
        s = pl.calc_sample(pl.LightInfo(*(jnp.repeat(l, 16, 0) for l in info)),
                           jnp.asarray(np.random.default_rng(3).uniform(
                               size=(16, 2)), jnp.float32),
                           jnp.zeros((16, 3)), skybox=sky)
        assert np.all(np.asarray(s.solid_angle_pdf) > 0)
        # radiance_scale goes through RGB8+log16 packing: ~0.1% quantization
        np.testing.assert_allclose(np.asarray(s.radiance), 2.0, rtol=5e-3)


@pytest.fixture(scope="module")
def cornell_scene(tmp_path_factory):
    p = tmp_path_factory.mktemp("l") / "c.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    return build_scene(gltf.load_file(p))


class TestPrepareLights:
    def test_counts_and_mapping(self, cornell_scene):
        sl = prepare_lights(cornell_scene)
        assert sl.num_local_lights == 2  # the emissive quad
        g2l = np.asarray(sl.geometry_to_light)
        emissive_geoms = np.where(g2l != RTXDI_INVALID_LIGHT_INDEX)[0]
        assert len(emissive_geoms) == 1
        assert g2l[emissive_geoms[0]] == 0
        # table holds locals + pad + environment
        assert sl.lights.center.shape[0] == sl.num_local_lights + 2
        env_type = int(pl.get_light_type(
            sl.lights.color_type_and_flags[sl.num_local_lights + 1]))
        assert env_type == pl.K_ENVIRONMENT

    def test_light_radiance_scaled(self, cornell_scene):
        sl = prepare_lights(cornell_scene)
        tri_lights = pl.LightInfo(*(l[:2] for l in sl.lights))
        rad = np.asarray(pl.unpack_light_color(tri_lights))
        np.testing.assert_allclose(rad, 24.0, rtol=0.05)  # 2.0 * 12

    def test_pdf_texture_flux(self, cornell_scene):
        sl = prepare_lights(cornell_scene)
        base = np.asarray(sl.local_pdf_mips[0])
        assert (base > 0).sum() == 2  # one texel per emissive triangle
        # last mip = average
        assert float(sl.local_pdf_mips[-1][0, 0]) > 0


class TestPdfMipmap:
    def test_sampling_distribution(self):
        # 4x4 texture with one dominant texel
        base = jnp.asarray(np.full((4, 4), 1.0, np.float32))
        base = base.at[2, 3].set(97.0)  # total = 15 + 97 = 112
        mips = pdf_texture.build_mip_chain(base)
        n = 20000
        idx = jnp.arange(n, dtype=jnp.uint32)
        state = rtrng.RngState(seed=rtrng.jenkins_hash(idx),
                               index=jnp.ones_like(idx))
        x, y, pdf, _ = pdf_texture.sample_pdf_mipmap(state, mips, (n,))
        hits = (np.asarray(x) == 3) & (np.asarray(y) == 2)
        assert abs(hits.mean() - 97.0 / 112.0) < 0.02
        # pdf of the dominant texel matches its probability
        np.testing.assert_allclose(np.asarray(pdf)[hits], 97.0 / 112.0,
                                   rtol=1e-4)

    def test_zero_texture_dead(self):
        mips = pdf_texture.build_mip_chain(jnp.zeros((4, 4)))
        state = rtrng.RngState(seed=jnp.uint32([1]), index=jnp.uint32([1]))
        _, _, pdf, _ = pdf_texture.sample_pdf_mipmap(state, mips, (1,))
        assert float(pdf[0]) == 0.0

    def test_evaluate_matches_probability(self):
        base = jnp.asarray(np.random.default_rng(5).uniform(
            0.1, 2.0, (8, 8)), jnp.float32)
        mips = pdf_texture.build_mip_chain(base)
        p = np.asarray(pdf_texture.evaluate_pdf_texture(
            mips, jnp.arange(8), jnp.zeros(8, jnp.int32)))
        expected = np.asarray(base)[0, :8] / np.asarray(base).sum()
        np.testing.assert_allclose(p, expected, rtol=1e-3)

    def test_texture_size(self):
        assert pdf_texture.compute_pdf_texture_size(1) == (1, 1, 1)
        assert pdf_texture.compute_pdf_texture_size(2) == (2, 1, 2)
        assert pdf_texture.compute_pdf_texture_size(5) == (4, 2, 3)
        assert pdf_texture.compute_pdf_texture_size(1000) == (32, 32, 6)

    def test_neighbor_offsets_disk(self):
        off = np.asarray(pdf_texture.fill_neighbor_offsets(512))
        r = np.linalg.norm(off, axis=-1)
        assert np.all(r <= 1.0 + 1e-5)
        assert r.max() > 0.7  # fills the disk
