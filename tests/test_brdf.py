"""Statistical and invariant tests for the BRDF/sampling math
(ref: Helpers.glsl, RtxdiApplicationBridge.glsl)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracer2.utils import brdf


def _uniforms(n, d, seed=0):
    return jnp.asarray(np.random.default_rng(seed).uniform(size=(n, d)),
                       jnp.float32)


def test_sample_triangle_barycentric_valid():
    b = brdf.sample_triangle(_uniforms(1000, 2))
    b = np.asarray(b)
    assert np.allclose(b.sum(-1), 1.0, atol=1e-5)
    assert np.all(b >= -1e-6)


def test_random_from_barycentric_inverse():
    r = _uniforms(500, 2, seed=1)
    bary = brdf.sample_triangle(r)
    r2 = brdf.random_from_barycentric(bary)
    np.testing.assert_allclose(np.asarray(r2), np.asarray(r), atol=1e-5)


def test_onb_orthonormal():
    n = np.random.default_rng(2).normal(size=(200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t, b = brdf.construct_onb(jnp.asarray(n))
    t, b = np.asarray(t), np.asarray(b)
    assert np.abs(np.sum(t * n, -1)).max() < 1e-5
    assert np.abs(np.sum(b * n, -1)).max() < 1e-5
    assert np.abs(np.sum(t * b, -1)).max() < 1e-5
    assert np.abs(np.linalg.norm(t, axis=-1) - 1).max() < 1e-5


def test_tangent_world_roundtrip():
    n = np.random.default_rng(3).normal(size=(100, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = np.random.default_rng(4).normal(size=(100, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    n, w = jnp.asarray(n), jnp.asarray(w)
    h = brdf.world_to_tangent(n, w)
    w2 = brdf.tangent_to_world(n, h)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-5)


def test_cos_hemisphere_stats():
    d, pdf = brdf.sample_cos_hemisphere(_uniforms(20000, 2, seed=5))
    d, pdf = np.asarray(d), np.asarray(pdf)
    assert np.all(d[:, 2] >= 0)
    np.testing.assert_allclose(pdf, d[:, 2] / np.pi, atol=1e-5)
    # E[cos theta] for cosine-weighted = 2/3
    assert abs(d[:, 2].mean() - 2.0 / 3.0) < 0.01


def test_sphere_sampling_uniform():
    d, pdf = brdf.sample_sphere(_uniforms(20000, 2, seed=6))
    d = np.asarray(d)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    assert np.abs(d.mean(0)).max() < 0.02
    np.testing.assert_allclose(np.asarray(pdf), 0.25 / np.pi)


def test_vndf_half_vectors_above_horizon():
    ve = jnp.asarray([[0.3, -0.2, 0.9]] * 1000, jnp.float32)
    ve = ve / jnp.linalg.norm(ve, axis=-1, keepdims=True)
    h = brdf.importance_sample_ggx_vndf(_uniforms(1000, 2, seed=7),
                                        jnp.float32(0.5), ve)
    h = np.asarray(h / jnp.linalg.norm(h, axis=-1, keepdims=True))
    assert np.all(h[:, 2] >= -1e-6)


def test_ggx_d_quirk_vs_correct():
    noh = jnp.float32(0.8)
    alpha = jnp.float32(1.0)
    d_quirk = float(brdf.ggx_d(noh, alpha, quirk=True))
    d_correct = float(brdf.ggx_d(noh, alpha, quirk=False))
    # correct: (a+b)^2 = 1 at alpha=1 -> D = 1/pi
    assert abs(d_correct - 1.0 / np.pi) < 1e-6
    # quirk: denom = 1 + noh^2 - noh^4
    denom = 1 + 0.8**2 - 0.8**4
    assert abs(d_quirk - 1.0 / (np.pi * denom)) < 1e-6


def test_schlick_limits():
    f0 = jnp.asarray([0.04, 0.5, 1.0], jnp.float32)
    at0 = np.asarray(brdf.schlick_fresnel(f0, jnp.float32(1.0)))
    np.testing.assert_allclose(at0, np.asarray(f0), atol=1e-6)
    at90 = np.asarray(brdf.schlick_fresnel(f0, jnp.float32(0.0)))
    np.testing.assert_allclose(at90, 1.0, atol=1e-6)


def test_lambert():
    n = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    incident = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)  # arriving downward
    assert abs(float(brdf.lambert(n, incident)[0]) - 1.0 / np.pi) < 1e-6
    # below horizon clamps to 0
    assert float(brdf.lambert(n, -incident)[0]) == 0.0


def test_equirect_uv_direction_consistency():
    # direction -> uv -> direction (uses the reference's own pair of
    # functions, which define u with different conventions; check the
    # composition dir->uv yields uv in range and v roundtrips elevation)
    d = np.random.default_rng(8).normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = np.asarray(brdf.direction_to_equirect_uv(jnp.asarray(d)))
    assert np.all(uv >= -1e-6) and np.all(uv <= 1 + 1e-6)
    # elevation roundtrip: y = sin(elevation), v = 0.5 - el/pi
    el = (0.5 - uv[:, 1]) * np.pi
    np.testing.assert_allclose(np.sin(el), d[:, 1], atol=1e-5)


def test_reflect():
    i = jnp.asarray([[1.0, -1.0, 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    r = np.asarray(brdf.reflect(i, n))
    np.testing.assert_allclose(r, [[1.0, 1.0, 0.0]], atol=1e-6)


def test_ggx_brdf_reciprocity_shape():
    v = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    l = brdf.normalize(jnp.asarray([[0.5, 0.0, 1.0]], jnp.float32))
    n = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    f0 = jnp.asarray([[0.04, 0.04, 0.04]], jnp.float32)
    s = brdf.ggx_times_ndotl(v, l, n, jnp.float32(0.5), f0)
    assert s.shape == (1, 3)
    assert np.all(np.asarray(s) >= 0)
