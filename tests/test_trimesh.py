"""Triangle meshes: Möller-Trumbore geometry and OBJ IO."""

import jax.numpy as jnp
import numpy as np

from csgrenderer.io import obj as obj_io
from csgrenderer.render.trimesh import icosphere, make_mesh
from csgrenderer.scene import Material


def test_single_triangle_hit_and_miss():
    mesh = make_mesh(
        [[-1, -1, -3], [1, -1, -3], [0, 1, -3]], [[0, 1, 2]],
        Material.lambertian((0.5, 0.5, 0.5)),
    )
    o = jnp.asarray([[0, 0, 0], [0, 0, 0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 0, 1]], jnp.float32)
    h = mesh.nearest_hit(o, d)
    assert bool(h.hit[0]) and not bool(h.hit[1])
    np.testing.assert_allclose(float(h.t[0]), 3.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-6)
    assert bool(h.front_face[0])


def test_icosphere_approximates_sphere():
    mesh = icosphere((0, 0, -5), 1.0, Material.normal_map(), subdivisions=2)
    assert mesh.num_faces == 20 * 16
    # rays through the center hit near t = 4 (within facet tolerance)
    o = jnp.zeros((1, 3), jnp.float32)
    d = jnp.asarray([[0, 0, -1]], jnp.float32)
    h = mesh.nearest_hit(o, d)
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 4.0) < 0.05


def test_watertight_no_leaks_through_edges():
    """Rays at random angles through an icosphere must always hit it twice
    (enter+exit) — fan out secondary rays from inside."""
    mesh = icosphere((0, 0, 0), 1.0, Material.lambertian((0.5, 0.5, 0.5)), 2)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    o = np.zeros((512, 3), np.float32)
    h = mesh.nearest_hit(jnp.asarray(o), jnp.asarray(d))
    assert bool(np.asarray(h.hit).all())  # no edge/vertex leaks from inside


def test_obj_roundtrip(tmp_path):
    mesh = icosphere((0, 0, 0), 1.0, Material.normal_map(), 1)
    # rebuild vertices/faces from the soup for the writer
    v0 = np.asarray(mesh.v0)
    verts = np.concatenate(
        [v0, v0 + np.asarray(mesh.e1), v0 + np.asarray(mesh.e2)]
    )
    f = len(v0)
    faces = np.stack(
        [np.arange(f), np.arange(f) + f, np.arange(f) + 2 * f], axis=1
    )
    p = tmp_path / "ico.obj"
    obj_io.write_obj(p, verts, faces)
    mesh2 = obj_io.load_mesh(p, Material.normal_map())
    assert mesh2.num_faces == mesh.num_faces
    np.testing.assert_allclose(
        np.asarray(mesh2.v0), np.asarray(mesh.v0), atol=1e-5
    )


def test_obj_polygon_fan_and_negative_indices(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1/1/1 2/2/2 3/3/3 4/4/4\n"  # quad with v/vt/vn tokens
        "f -4 -3 -2\n"  # negative indices
    )
    verts, faces = obj_io.read_obj(p)
    assert len(verts) == 4 and len(faces) == 3  # 2 from the fan + 1
