"""Unit tests for the math layer (vec + quaternion)."""

import jax.numpy as jnp
import numpy as np
import pytest

from csgrenderer.math import quaternion as quat
from csgrenderer.math import vec


def test_vec3_build_and_dot():
    v = vec.vec3(1.0, 2.0, 3.0)
    w = vec.vec3(4.0, -5.0, 6.0)
    assert v.shape == (3,)
    np.testing.assert_allclose(vec.dot(v, w), 1 * 4 - 2 * 5 + 3 * 6)


def test_vec3_batched_broadcast():
    v = jnp.ones((4, 5, 3))
    w = jnp.full((4, 5, 3), 2.0)
    assert vec.dot(v, w).shape == (4, 5)
    np.testing.assert_allclose(vec.dot(v, w), 6.0)


def test_normalized_correct_math():
    v = jnp.array([3.0, 0.0, 4.0])
    np.testing.assert_allclose(vec.normalized(v), [0.6, 0.0, 0.8], atol=1e-6)
    np.testing.assert_allclose(vec.length(vec.normalized(v)), 1.0, atol=1e-6)


def test_normalized_ref_bugcompat_divides_by_lengthsqr():
    # The reference's wo_vec3_normalized scales by 1/length^2
    # (wmath.impl.h:48-55); the compat shim must reproduce that.
    v = jnp.array([3.0, 0.0, 4.0])
    np.testing.assert_allclose(
        vec.normalized_ref_bugcompat(v), [3 / 25, 0.0, 4 / 25], atol=1e-7
    )


def test_reflect():
    d = jnp.array([1.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    np.testing.assert_allclose(vec.reflect(d, n), [1.0, 1.0, 0.0], atol=1e-6)


def test_refract_straight_through():
    # eta ratio 1 => direction unchanged for a unit vector
    d = vec.normalized(jnp.array([1.0, -1.0, 0.0]))
    n = jnp.array([0.0, 1.0, 0.0])
    out = vec.refract(d, n, jnp.float32(1.0))
    np.testing.assert_allclose(out, d, atol=1e-6)


def test_quaternion_identity_rotation():
    q = quat.identity()
    v = jnp.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(quat.rotate(q, v), v, atol=1e-6)


def test_quaternion_axis_angle_90deg():
    q = quat.from_axis_angle(jnp.array([0.0, 0.0, 1.0]), jnp.pi / 2)
    v = jnp.array([1.0, 0.0, 0.0])
    np.testing.assert_allclose(quat.rotate(q, v), [0.0, 1.0, 0.0], atol=1e-6)


def test_quaternion_compose_matches_sequential():
    qa = quat.from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.7)
    qb = quat.from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -1.2)
    v = jnp.array([0.3, -2.0, 1.5])
    seq = quat.rotate(qa, quat.rotate(qb, v))
    comp = quat.rotate(quat.multiply(qa, qb), v)
    np.testing.assert_allclose(seq, comp, atol=1e-5)


def test_quaternion_inverse_roundtrip():
    q = quat.from_axis_angle(jnp.array([1.0, 2.0, -0.5]), 2.1)
    v = jnp.array([0.1, 0.2, 0.3])
    np.testing.assert_allclose(
        quat.rotate_inverse(q, quat.rotate(q, v)), v, atol=1e-5
    )


def test_quaternion_rotation_matrix_agrees():
    q = quat.from_axis_angle(jnp.array([1.0, -1.0, 0.5]), 1.3)
    v = jnp.array([0.7, 0.1, -0.4])
    m = quat.to_rotation_matrix(q)
    np.testing.assert_allclose(m @ v, quat.rotate(q, v), atol=1e-5)
    # orthonormal
    np.testing.assert_allclose(m @ m.T, jnp.eye(3), atol=1e-5)


def test_quaternion_rotation_preserves_length():
    q = quat.from_axis_angle(jnp.array([0.2, 0.9, -0.1]), 0.44)
    v = jnp.array([[1.0, 2.0, 2.0], [0.0, 3.0, -4.0]])
    np.testing.assert_allclose(
        vec.length(quat.rotate(q, v)), vec.length(v), atol=1e-5
    )
