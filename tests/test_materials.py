"""Material scatter tests (divergence-free dispatch)."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.math import vec
from csgrenderer.render import materials
from csgrenderer.render.sampling import uniform4


def mk(kind, albedo=(0.5, 0.5, 0.5), param=0.0, d=(0, 0, -1), n=(0, 0, 1),
       front=True, u=(0.1, 0.2, 0.99, 0.5)):
    batch = lambda x: jnp.array([x], jnp.float32)
    return materials.scatter(
        jnp.array([kind], jnp.int32),
        batch(albedo),
        jnp.array([param], jnp.float32),
        batch(d),
        batch(n),
        jnp.array([front]),
        batch(u),
    )


def test_normal_map_terminates_with_reference_shading():
    sc = mk(materials.KIND_NORMAL_MAP, n=(0.0, 1.0, 0.0))
    assert bool(sc.terminate[0])
    np.testing.assert_allclose(sc.emitted[0], [0.5, 1.0, 0.5], atol=1e-6)


def test_lambertian_scatters_into_upper_hemisphere():
    for u in np.random.default_rng(0).random((32, 4)):
        sc = mk(materials.KIND_LAMBERTIAN, u=tuple(u))
        assert not bool(sc.terminate[0])
        assert float(vec.dot(sc.direction, jnp.array([0.0, 0.0, 1.0]))[0]) > -1e-6
        np.testing.assert_allclose(sc.attenuation[0], [0.5, 0.5, 0.5])


def test_metal_mirror_reflection_no_fuzz():
    d = vec.normalized(jnp.array([1.0, 0.0, -1.0]))
    sc = mk(materials.KIND_METAL, d=tuple(np.asarray(d)), param=0.0)
    expect = vec.reflect(d, jnp.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(sc.direction[0], expect, atol=1e-5)
    assert not bool(sc.terminate[0])


def test_metal_grazing_absorption():
    # fuzz pushes the scattered ray below the surface -> absorbed
    d = vec.normalized(jnp.array([1.0, 0.0, -0.001]))
    sc = mk(materials.KIND_METAL, d=tuple(np.asarray(d)), param=1.0,
            u=(0.9, 0.9, 0.0, 0.0))
    # whether absorbed depends on the fuzz draw; check consistency with dot
    below = float(vec.dot(sc.direction, jnp.array([0.0, 0.0, 1.0]))[0]) <= 0
    assert bool(sc.terminate[0]) == below


def test_dielectric_total_internal_reflection():
    # from inside glass (front_face=False, eta=1.5), steep grazing angle
    d = vec.normalized(jnp.array([1.0, 0.0, -0.1]))
    sc = mk(materials.KIND_DIELECTRIC, d=tuple(np.asarray(d)), param=1.5,
            front=False, u=(0.5, 0.5, 0.999, 0.5))
    expect = vec.reflect(d, jnp.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(sc.direction[0], expect, atol=1e-5)
    np.testing.assert_allclose(sc.attenuation[0], [1.0, 1.0, 1.0])


def test_dielectric_refracts_head_on():
    # head-on: refraction continues straight, Schlick prob ~ 0.04 < u2
    sc = mk(materials.KIND_DIELECTRIC, d=(0, 0, -1), param=1.5,
            u=(0.5, 0.5, 0.99, 0.5))
    np.testing.assert_allclose(sc.direction[0], [0.0, 0.0, -1.0], atol=1e-5)


def test_dielectric_schlick_reflection_branch():
    # u2 = 0 forces the reflect branch regardless of probability
    d = vec.normalized(jnp.array([1.0, 0.0, -1.0]))
    sc = mk(materials.KIND_DIELECTRIC, d=tuple(np.asarray(d)), param=1.5,
            u=(0.5, 0.5, 0.0, 0.5))
    expect = vec.reflect(d, jnp.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(sc.direction[0], expect, atol=1e-5)


def test_emissive_terminates_and_emits():
    sc = mk(materials.KIND_EMISSIVE, albedo=(3.0, 2.0, 1.0))
    assert bool(sc.terminate[0])
    np.testing.assert_allclose(sc.emitted[0], [3.0, 2.0, 1.0])


def test_uniform4_deterministic_and_in_range():
    u = uniform4(jnp.arange(100, dtype=jnp.uint32), 1, 2, 3)
    v = uniform4(jnp.arange(100, dtype=jnp.uint32), 1, 2, 3)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # different counters decorrelate
    w = uniform4(jnp.arange(100, dtype=jnp.uint32), 1, 2, 4)
    assert not np.allclose(np.asarray(u), np.asarray(w))


def test_uniform4_mean_is_half():
    u = uniform4(jnp.arange(4096, dtype=jnp.uint32), 7, 9, 11)
    assert abs(float(u.mean()) - 0.5) < 0.02
