"""Triangle meshes — the reference's own declared next milestone.

The reference README scopes itself to CSG "with meshes later"
(/root/reference/README.md:1-13); this module delivers the later part:
a struct-of-arrays triangle soup with per-face materials, a
vectorized Möller-Trumbore nearest-hit that plugs straight into
``render_image`` (same SurfaceHit contract as SphereScene), and procedural
builders. Meshes render through this plain JAX path on every platform.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import Array

from ..math import vec
from .integrator import SurfaceHit


class MeshScene(NamedTuple):
    """Triangle soup: v0 + edge vectors, per-face materials."""

    v0: Array  # [F, 3]
    e1: Array  # [F, 3] = v1 - v0
    e2: Array  # [F, 3] = v2 - v0
    mat_kind: Array  # [F] int32
    albedo: Array  # [F, 3]
    mat_param: Array  # [F]

    @property
    def num_faces(self) -> int:
        return self.v0.shape[0]

    @property
    def face_normals(self) -> Array:
        """Unit geometric normals (right-hand winding)."""
        return vec.normalized(jnp.cross(self.e1, self.e2), eps=1e-20)

    def nearest_hit(
        self, o: Array, d: Array, eps: float = 1e-3,
        face_chunk: int | None = None,
    ) -> SurfaceHit:
        """Möller-Trumbore over all faces, vectorized [N, F].

        ``face_chunk``: when set, the [N, F] candidate plane is never
        materialized — a ``lax.scan`` over F/face_chunk face blocks carries
        only the running (best t, best face id) per ray, bounding memory at
        N x face_chunk regardless of mesh size (the AOV/G-buffer path at
        100k+ faces).
        """
        flat_o = o.reshape(-1, 3)
        flat_d = d.reshape(-1, 3)

        def candidates(v0, e1, e2):
            """Per-(ray, face-block) hit t: [N, C], misses = 1e30."""
            pvec = jnp.cross(flat_d[:, None, :], e2[None, :, :])  # [N,C,3]
            det = jnp.sum(e1[None] * pvec, axis=-1)  # [N,C]
            inv_det = 1.0 / det  # +-inf/NaN on degenerate: comparisons reject
            tvec = flat_o[:, None, :] - v0[None]
            u = jnp.sum(tvec * pvec, axis=-1) * inv_det
            qvec = jnp.cross(tvec, e1[None])
            v = jnp.sum(flat_d[:, None, :] * qvec, axis=-1) * inv_det
            t = jnp.sum(e2[None] * qvec, axis=-1) * inv_det
            valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
            return jnp.where(valid, t, jnp.float32(1e30))

        n_rays = flat_o.shape[0]
        faces = self.num_faces
        if face_chunk is None or face_chunk >= faces:
            t = candidates(self.v0, self.e1, self.e2)
            idx = jnp.argmin(t, axis=-1)  # [N]
            t_hit = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
        else:
            from jax import lax

            chunk = int(face_chunk)
            pad = (-faces) % chunk
            # zero-padded faces have det=0 -> NaN u/v -> rejected above
            v0p = jnp.concatenate([self.v0, jnp.zeros((pad, 3), self.v0.dtype)])
            e1p = jnp.concatenate([self.e1, jnp.zeros((pad, 3), self.e1.dtype)])
            e2p = jnp.concatenate([self.e2, jnp.zeros((pad, 3), self.e2.dtype)])
            blocks = (faces + pad) // chunk
            v0b = v0p.reshape(blocks, chunk, 3)
            e1b = e1p.reshape(blocks, chunk, 3)
            e2b = e2p.reshape(blocks, chunk, 3)

            def step(carry, block):
                best_t, best_i = carry
                v0c, e1c, e2c, base = block
                t = candidates(v0c, e1c, e2c)  # [N, C]
                li = jnp.argmin(t, axis=-1)
                lt = jnp.take_along_axis(t, li[:, None], axis=-1)[:, 0]
                take = lt < best_t
                best_i = jnp.where(take, base + li.astype(jnp.int32), best_i)
                best_t = jnp.where(take, lt, best_t)
                return (best_t, best_i), None

            init = (
                jnp.full((n_rays,), 1e30, jnp.float32),
                jnp.zeros((n_rays,), jnp.int32),
            )
            bases = (jnp.arange(blocks, dtype=jnp.int32) * chunk)
            (t_hit, idx), _ = lax.scan(step, init, (v0b, e1b, e2b, bases))
        hit = t_hit < jnp.float32(5e29)

        n_geo = self.face_normals[idx]  # [N,3]
        front = vec.dot(flat_d, n_geo) < 0.0
        n = jnp.where(front[:, None], n_geo, -n_geo)
        batch = o.shape[:-1]
        return SurfaceHit(
            t=t_hit.reshape(batch),
            hit=hit.reshape(batch),
            normal=n.reshape(batch + (3,)),
            front_face=front.reshape(batch),
            mat_kind=self.mat_kind[idx].reshape(batch),
            albedo=self.albedo[idx].reshape(batch + (3,)),
            mat_param=self.mat_param[idx].reshape(batch),
        )


def make_mesh(vertices, faces, material) -> MeshScene:
    """Build a MeshScene from [V,3] vertices + [F,3] int faces and one
    scene.Material applied to every face."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    v0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - v0
    e2 = v[f[:, 2]] - v0
    n = f.shape[0]
    kind = np.full(n, material.kind, np.int32)
    alb = np.tile(np.asarray(material.albedo, np.float32), (n, 1))
    prm = np.full(n, material.param, np.float32)
    return MeshScene(
        v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
        mat_kind=jnp.asarray(kind), albedo=jnp.asarray(alb),
        mat_param=jnp.asarray(prm),
    )


def concat_meshes(*meshes: MeshScene) -> MeshScene:
    return MeshScene(*(jnp.concatenate(parts) for parts in zip(*meshes)))


# -- procedural builders -----------------------------------------------------


def quad(p0, p1, p2, p3, material) -> MeshScene:
    """Two-triangle quad with corners in winding order."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    return make_mesh(verts, [[0, 1, 2], [0, 2, 3]], material)


def icosphere(center, radius, material, subdivisions: int = 1) -> MeshScene:
    """Subdivided icosahedron (outward winding)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    vlist = [tuple(v) for v in verts]
    cache: dict = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(vlist[a]) + np.asarray(vlist[b])
            m /= np.linalg.norm(m)
            cache[key] = len(vlist)
            vlist.append(tuple(m))
        return cache[key]

    for _ in range(subdivisions):
        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt

    v = np.asarray(vlist, np.float64) * float(radius) + np.asarray(
        center, np.float64
    )
    return make_mesh(v, faces, material)
