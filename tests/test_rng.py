"""RNG parity tests: jnp implementation vs a pure-Python integer oracle of the
GLSL murmur3 sampler (ref: Helpers.glsl:13-64, RtxdiMath.hlsli:69-79)."""

import numpy as np
import jax.numpy as jnp

from raytracer2.utils import rng as rtrng

M32 = 0xFFFFFFFF


def jenkins_py(a):
    a &= M32
    a = ((a + 0x7ED55D16) + (a << 12)) & M32
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & M32
    a = ((a + 0x165667B1) + (a << 5)) & M32
    a = ((a + 0xD3A2646C) ^ (a << 9)) & M32
    a = ((a + 0xFD7046C5) + (a << 3)) & M32
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & M32
    return a


def murmur3_py(seed, index):
    def rot32(x, y):
        return ((x << y) | (x >> (32 - y))) & M32

    h = seed & M32
    k = (index * 0xCC9E2D51) & M32
    k = rot32(k, 15)
    k = (k * 0x1B873593) & M32
    h ^= k
    h = (rot32(h, 13) * 5 + 0xE6546B64) & M32
    h ^= 4
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


def test_jenkins_matches_oracle():
    vals = [0, 1, 2, 123456789, 0xDEADBEEF, 0xFFFFFFFF]
    got = rtrng.jenkins_hash(jnp.asarray(vals, jnp.uint32))
    assert [int(x) for x in np.asarray(got)] == [jenkins_py(v) for v in vals]


def test_murmur3_matches_oracle():
    seeds = [0, 7, 0xCAFEBABE, 999999]
    state = rtrng.RngState(
        seed=jnp.asarray(seeds, jnp.uint32),
        index=jnp.ones(len(seeds), jnp.uint32))
    bits, state2 = rtrng.murmur3(state)
    assert [int(x) for x in np.asarray(bits)] == [murmur3_py(s, 1) for s in seeds]
    bits2, _ = rtrng.murmur3(state2)
    assert [int(x) for x in np.asarray(bits2)] == [murmur3_py(s, 2) for s in seeds]


def test_uniform_range_and_distribution():
    xs = jnp.arange(4096, dtype=jnp.uint32)
    state = rtrng.RngState(seed=rtrng.jenkins_hash(xs),
                           index=jnp.ones_like(xs))
    u, state = rtrng.sample_uniform(state)
    u = np.asarray(u)
    assert np.all(u >= 0.0) and np.all(u < 1.0)
    assert abs(u.mean() - 0.5) < 0.02
    assert abs(np.var(u) - 1.0 / 12.0) < 0.01


def test_uniform_bit_construction_matches_glsl():
    # asfloat((v & mask) | asuint(1.f)) - 1.f with known bits
    state = rtrng.RngState(seed=jnp.uint32(42), index=jnp.uint32(1))
    u, _ = rtrng.sample_uniform(state)
    bits = murmur3_py(42, 1)
    expected = np.frombuffer(
        np.uint32((bits & ((1 << 23) - 1)) | 0x3F800000).tobytes(),
        dtype=np.float32)[0] - 1.0
    assert abs(float(u) - expected) < 1e-9


def test_init_random_sampler_zcurve_seed():
    from raytracer2.utils.packing import zcurve_to_linear

    px = jnp.asarray([5], jnp.uint32)
    py = jnp.asarray([9], jnp.uint32)
    st = rtrng.init_random_sampler(px, py, 3)
    linear = int(zcurve_to_linear(px, py)[0])
    assert int(st.seed[0]) == (jenkins_py(linear) + 3) & M32
    assert int(st.index[0]) == 1


def test_pcg_random_value_range():
    state = jnp.arange(1, 1025, dtype=jnp.uint32)
    v, state = rtrng.random_value(state)
    v = np.asarray(v)
    assert np.all(v >= 0.0) and np.all(v <= 1.0)
    assert abs(v.mean() - 0.5) < 0.05
