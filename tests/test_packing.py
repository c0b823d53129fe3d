"""Unit tests for bit-packing parity (ref: packing.glsl, RtxdiMath.hlsli)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer2.utils import packing as pk


def _rand_dirs(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class TestUnorm:
    def test_roundtrip_8(self):
        x = jnp.linspace(0.0, 1.0, 257)
        out = pk.unpack_unorm(pk.pack_unorm(x, 8), 8)
        assert np.max(np.abs(np.asarray(out) - np.asarray(x))) <= 0.5 / 255 + 1e-6

    def test_known_values(self):
        # floor(r*mask + 0.5) semantics from packing.glsl:3-10
        assert int(pk.pack_unorm(jnp.float32(1.0), 8)) == 255
        assert int(pk.pack_unorm(jnp.float32(0.0), 8)) == 0
        assert int(pk.pack_unorm(jnp.float32(0.5), 11)) == 1024  # floor(1023.5+0.5)

    def test_r11g11b10_roundtrip(self):
        rgb = jnp.asarray(np.random.default_rng(1).uniform(size=(64, 3)), jnp.float32)
        out = pk.unpack_r11g11b10_ufloat(pk.pack_r11g11b10_ufloat(rgb))
        assert np.max(np.abs(np.asarray(out) - np.asarray(rgb))) < 1.0 / 1023

    def test_rgba8_gamma_roundtrip(self):
        rgba = jnp.asarray(np.random.default_rng(2).uniform(size=(64, 4)), jnp.float32)
        out = pk.unpack_rgba8_gamma_ufloat(pk.pack_rgba8_gamma_ufloat(rgba))
        # gamma-encoded 8-bit: generous linear tolerance
        assert np.max(np.abs(np.asarray(out) - np.asarray(rgba))) < 0.03


class TestF16:
    def test_r16g16_roundtrip(self):
        rg = jnp.asarray([[1.0, -2.5], [0.125, 65504.0], [0.0, -0.0]], jnp.float32)
        out = pk.unpack_r16g16_float(pk.pack_r16g16_float(rg))
        np.testing.assert_allclose(np.asarray(out), np.asarray(rg), rtol=1e-3)

    def test_r16g16b16a16_shape(self):
        rgba = jnp.ones((4, 5, 4), jnp.float32) * 3.5
        packed = pk.pack_r16g16b16a16_float(rgba)
        assert packed.shape == (4, 5, 2) and packed.dtype == jnp.uint32
        out = pk.unpack_r16g16b16a16_float(packed)
        np.testing.assert_allclose(np.asarray(out), 3.5, rtol=1e-3)


class TestOctahedral:
    def test_unorm32_roundtrip(self):
        n = jnp.asarray(_rand_dirs(512))
        dec = pk.oct_unorm32_to_ndir(pk.ndir_to_oct_unorm32(n))
        dots = np.sum(np.asarray(dec) * np.asarray(n), axis=-1)
        assert np.min(dots) > 0.99999  # 16-bit oct is accurate to ~1e-4 rad

    def test_snorm2x16_roundtrip(self):
        n = jnp.asarray(_rand_dirs(512, seed=3))
        dec = pk.decode_normal_snorm2x16(pk.encode_normal_snorm2x16(n))
        dots = np.sum(np.asarray(dec) * np.asarray(n), axis=-1)
        assert np.min(dots) > 0.99999

    def test_axes_exact(self):
        axes = jnp.asarray(
            [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]],
            jnp.float32)
        dec = pk.oct_unorm32_to_ndir(pk.ndir_to_oct_unorm32(axes))
        np.testing.assert_allclose(np.asarray(dec), np.asarray(axes), atol=1e-3)


class TestZCurve:
    def test_explode_compact_inverse(self):
        x = jnp.arange(0, 1 << 16, 97, dtype=jnp.uint32)
        assert np.all(np.asarray(pk.integer_compact(pk.integer_explode(x))) ==
                      np.asarray(x))

    def test_known_pattern(self):
        # 0b11111111 -> 0b0101010101010101 (RtxdiMath.hlsli:31-32 doc example)
        assert int(pk.integer_explode(jnp.uint32(0xFF))) == 0x5555

    def test_zcurve_roundtrip(self):
        xs = jnp.arange(0, 256, 7, dtype=jnp.uint32)
        ys = jnp.arange(3, 259, 7, dtype=jnp.uint32) % 256
        idx = pk.zcurve_to_linear(xs, ys)
        rx, ry = pk.linear_to_zcurve(idx)
        assert np.all(np.asarray(rx) == np.asarray(xs))
        assert np.all(np.asarray(ry) == np.asarray(ys))

    def test_python_oracle(self):
        def explode_py(v):
            out = 0
            for i in range(16):
                out |= ((v >> i) & 1) << (2 * i)
            return out

        for v in [0, 1, 2, 0xABCD, 0xFFFF, 12345]:
            assert int(pk.integer_explode(jnp.uint32(v))) == explode_py(v)


class TestLogLuv:
    def test_roundtrip_hdr(self):
        # plausible colors: base chroma in [0.05, 1] x HDR intensity.
        # (independent per-channel exponentials would exceed the 9-bit
        # chroma gamut, which LogLuv clips by design)
        rng = np.random.default_rng(4)
        base = rng.uniform(0.05, 1.0, size=(256, 3))
        intensity = np.exp(rng.uniform(np.log(1e-3), np.log(1e4), size=(256, 1)))
        rgb = jnp.asarray(base * intensity, jnp.float32)
        dec = pk.decode_logluv_to_rgb(pk.encode_rgb_to_logluv(rgb))
        rel = np.abs(np.asarray(dec) - np.asarray(rgb)) / (np.asarray(rgb) + 1e-6)
        assert np.median(rel) < 0.03
        # luminance (14-bit log) is much tighter than chroma
        lum = np.asarray(rgb) @ [0.2126, 0.7152, 0.0722]
        lum_dec = np.asarray(dec) @ [0.2126, 0.7152, 0.0722]
        assert np.median(np.abs(lum_dec - lum) / (lum + 1e-9)) < 0.01

    def test_black_exact(self):
        z = jnp.zeros((3,), jnp.float32)
        assert int(pk.encode_rgb_to_logluv(z)) == 0
        np.testing.assert_array_equal(
            np.asarray(pk.decode_logluv_to_rgb(jnp.uint32(0))), 0.0)
