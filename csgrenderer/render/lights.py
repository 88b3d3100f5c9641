"""Next-event estimation (direct light sampling) for emissive spheres.

The reference has no lights at all (`Wo_Material` is declared and unused,
renderer.h:16); the RTIOW material set this framework implements includes
EMISSIVE (kind 4), and for emissive-lit scenes (black sky, small lamps)
plain unidirectional path tracing only finds light by randomly hitting a
lamp — variance scales with 1/solid-angle. NEE samples the lamps directly:

- at every LAMBERTIAN hit, pick one emissive sphere uniformly and sample a
  direction in the cone it subtends (RTIOW book 3's sphere pdf:
  pdf = 1 / (2 pi (1 - cos_theta_max)));
- trace a shadow ray; the light is visible iff the scene's nearest hit is
  not strictly closer than the analytic hit on the sampled lamp itself
  (identity-free occlusion test — no hit indices needed);
- add throughput * albedo/pi * cos * L_e * (n_lights / pdf), times the
  balance-heuristic MIS weight against the cosine BSDF strategy
  (nee_contribution folds both into one closed form);
- a lambertian-SCATTERED ray that then hits a lamp keeps its emission
  times the PARTNER weight (bsdf_mis_scale) — the two weights sum to 1
  for every lamp surface point, so the pairing is exactly unbiased
  (round 2's suppress-the-emission scheme was the w_L = 1 special case,
  biased for vertices inside a lamp's bounding sphere); specular chains
  and camera rays keep full emission.

This estimator is exact for scenes whose emitters are spheres; emissive
non-sphere leaves simply keep the BSDF-sampling path. The math here is
shared by the jnp reference integrator and the Triton kernels (plane
formulation in kernels/common.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import Array

from ..math import vec


class SphereLights(NamedTuple):
    """Struct-of-arrays emissive-sphere list (host-extracted)."""

    centers: Array  # [L, 3]
    radii: Array  # [L] (positive)
    emit: Array  # [L, 3] radiance

    @property
    def num_lights(self) -> int:
        return self.centers.shape[0]


def extract_lights(scene, return_ids: bool = False):
    """Emissive spheres of a SphereScene, or None if the scene has none.

    Host-side numpy (never traced): the light list is static scene data,
    like the kernels' packed tables. ``return_ids=True`` additionally
    returns the lamps' sphere indices in ``scene``'s ordering (the
    kernels' id space — the worklist shadow walk excludes the sampled
    lamp's own hit by this id).
    """
    kind = np.asarray(scene.mat_kind)
    ids = np.where(kind == 4)[0]
    if ids.size == 0:
        return (None, ids) if return_ids else None
    alb = np.asarray(scene.albedo, np.float32)
    lights = SphereLights(
        centers=np.asarray(scene.centers, np.float32)[ids],
        radii=np.abs(np.asarray(scene.radii, np.float32)[ids]),
        emit=alb[ids],
    )
    return (lights, ids) if return_ids else lights


def extract_tape_lights(tape, return_ids: bool = False):
    """Emissive SPHERE leaves of a CompiledTape as SphereLights, or None.

    The tape twin of ``extract_lights``: lamp centers are the leaves'
    baked world positions (``leaf_pos``), radii their sphere parameter.
    Exact for full-sphere lamps; a lamp whose sphere is modified by
    boolean ops still samples the full sphere (the shadow test against
    the real CSG surface keeps the estimator consistent wherever the
    lamp surface exists). ``return_ids``: also return the lamp leaf
    indices (static under topology: the tape kernel packs the lamp table
    from the tape's own leaf arrays on every call, so animated lamp
    positions need no re-extraction).
    """
    from ..scene.graph import NodeType

    kinds = np.asarray(tape.mat_kind)
    types = np.asarray(tape.leaf_types)
    ids = np.where((kinds == 4) & (types == int(NodeType.SPHERE)))[0]
    if ids.size == 0:
        return (None, ids) if return_ids else None
    lights = SphereLights(
        centers=np.asarray(tape.leaf_pos, np.float32)[ids],
        radii=np.abs(np.asarray(tape.leaf_params, np.float32)[ids, 0]),
        emit=np.asarray(tape.albedo, np.float32)[ids],
    )
    return (lights, ids) if return_ids else lights


def sample_sphere_cone(p: Array, c: Array, r, u1: Array, u2: Array):
    """Sample a direction from ``p`` toward sphere (c, r) uniformly in its
    subtended cone. Returns (unit direction [..., 3], inv_pdf [...]) with
    inv_pdf = 2 pi (1 - cos_theta_max); inv_pdf = 0 when p is inside the
    sphere (no valid cone — callers drop the sample)."""
    to_c = c - p
    dist2 = vec.dot(to_c, to_c)
    r2 = r * r
    outside = dist2 > r2 * jnp.float32(1.0 + 1e-6)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - r2 / jnp.maximum(dist2, 1e-20)))
    z = 1.0 + u2 * (cos_max - 1.0)  # cos(theta) uniform in [cos_max, 1]
    phi = jnp.float32(2.0 * np.pi) * u1
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))

    w = vec.normalized(to_c, eps=1e-20)
    # ONB around w (branchless Frisvad-style via sign trick)
    sign = jnp.where(w[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + w[..., 2])
    b = w[..., 0] * w[..., 1] * a
    t0 = jnp.stack(
        [1.0 + sign * w[..., 0] * w[..., 0] * a, sign * b, -sign * w[..., 0]],
        axis=-1,
    )
    t1 = jnp.stack([b, sign + w[..., 1] * w[..., 1] * a, -w[..., 1]], axis=-1)

    d = (
        (jnp.cos(phi) * sin_t)[..., None] * t0
        + (jnp.sin(phi) * sin_t)[..., None] * t1
        + z[..., None] * w
    )
    inv_pdf = jnp.where(
        outside, jnp.float32(2.0 * np.pi) * (1.0 - cos_max), 0.0
    )
    return d, inv_pdf


def sphere_ray_t(p: Array, d: Array, c: Array, r, eps: float = 1e-3) -> Array:
    """Nearest positive intersection t of a UNIT-direction ray with sphere
    (c, r); BIG (1e30) on miss. The shadow test's identity-free target
    distance."""
    oc = p - c
    half_b = vec.dot(oc, d)
    cc = vec.dot(oc, oc) - r * r
    disc = half_b * half_b - cc
    sq = jnp.sqrt(disc)  # NaN on miss -> comparisons reject
    t0 = -half_b - sq
    t1 = -half_b + sq
    t = jnp.where(t0 > eps, t0, t1)
    return jnp.where(t > eps, t, jnp.float32(1e30))


def nee_contribution(
    hit_fn, p, n, albedo, lights: SphereLights, u, pdf_b_fn=None
):
    """MIS-weighted direct-light estimate at a scattering hit point.

    ``u``: [..., 3] uniforms (light pick, cone u1, cone u2). Returns
    [..., 3] radiance (already BRDF-, pdf- and MIS-weighted; multiply by
    path throughput and the caller's material mask).

    Balance-heuristic MIS against the vertex's BSDF strategy: the light
    strategy's solid-angle density is pdf_L = 1 / (L * ip) with
    ip = 2 pi (1 - cos_theta_max); the BSDF's is ``pdf_b_fn(d, cos)``
    (default: the cosine lobe cos / pi). For the procedural RTIOW
    materials the BRDF value IS albedo * pdf_b, so the weighted
    contribution folds to the closed form
        albedo * L_e * q / (1 + q),   q = pdf_b * L * ip
    (= the pure-NEE scale times pdf_L / (pdf_L + pdf_B)). The partner
    weight is applied to BSDF-found lamp emission via bsdf_mis_scale —
    together they sum to 1 for every lamp surface point, replacing the
    round-2 suppress-emission scheme (which zeroed the BSDF side, i.e.
    w_L = 1, and was biased for vertices inside a lamp's sphere).
    ``pdf_b_fn`` lets glossy (fuzzy-metal) vertices pair with their own
    lobe (scatter_pdf_metal) — the round-3 firefly fix.
    """
    nl = lights.num_lights
    li = jnp.minimum((u[..., 0] * nl).astype(jnp.int32), nl - 1)
    # the light table may be host numpy (extract_lights) — lift for the
    # traced gather
    c = jnp.asarray(lights.centers)[li]
    r = jnp.asarray(lights.radii)[li]
    e = jnp.asarray(lights.emit)[li]

    d, inv_pdf = sample_sphere_cone(p, c, r, u[..., 1], u[..., 2])
    cos = vec.dot(n, d)
    if pdf_b_fn is None:
        pdf_b = jnp.maximum(cos, 0.0) * jnp.float32(1.0 / np.pi)
    else:
        pdf_b = pdf_b_fn(d, cos)
    t_light = sphere_ray_t(p, d, c, r)
    sh = hit_fn(p, d)
    occluded = sh.hit & (sh.t < t_light * (1.0 - 1e-4))
    ok = (pdf_b > 0.0) & (inv_pdf > 0.0) & (t_light < 1e29) & ~occluded
    q = pdf_b * jnp.float32(nl) * inv_pdf
    scale = jnp.where(ok, q / (1.0 + q), 0.0)
    return albedo * e * scale[..., None]


def scatter_pdf_lambertian(n, d_new):
    """Solid-angle pdf of the lambertian scatter (cosine-weighted):
    cos(theta)/pi for the normalized new direction. The carried
    "previous-vertex BSDF pdf" of the MIS pairing."""
    ud = vec.normalized(d_new, eps=1e-20)
    return jnp.maximum(vec.dot(n, ud), 0.0) * jnp.float32(1.0 / np.pi)


def scatter_pdf_metal(d_in, n, fuzz, d_new):
    """Solid-angle pdf of the RTIOW fuzzy-metal scatter.

    The material scatters d_new = reflect(unit(d_in), n) + fuzz * u with u
    uniform on the unit sphere, i.e. the ray endpoint is uniform on the
    radius-``fuzz`` sphere around the unit mirror direction r. For a unit
    query direction w with c = w . r, the sphere intersections at
    t± = c ± g, g = sqrt(c^2 - 1 + f^2) project to w with density
        pdf(w) = (t+^2 [t+ > 0] + t-^2 [t- > 0]) / (4 pi f g)
    (0 outside the cone, g^2 <= 0). For f < 1 both roots are positive in
    the cone and this folds to (2 c^2 - (1 - f^2)) / (2 pi f g). Checks:
    f -> 1 gives the cosine lobe c/pi around r (the lambertian trick on
    the mirror axis); f -> 0 is a delta (returned as 0 — mirror chains
    keep full emission, w_B -> 1 via the carried-pdf convention
    pdf_b == 0 means "not pairable").
    """
    ud = vec.normalized(d_in, eps=1e-20)
    r = ud - 2.0 * vec.dot(ud, n)[..., None] * n  # unit: |ud|=|n|=1
    w = vec.normalized(d_new, eps=1e-20)
    c = vec.dot(w, r)
    f = jnp.asarray(fuzz, jnp.float32)
    f_ok = f > jnp.float32(1e-4)
    f_safe = jnp.maximum(f, jnp.float32(1e-4))
    g2 = c * c - 1.0 + f_safe * f_safe
    g = jnp.sqrt(jnp.maximum(g2, jnp.float32(1e-20)))
    tp = c + g
    tm = c - g
    num = jnp.where(tp > 0.0, tp * tp, 0.0) + jnp.where(tm > 0.0, tm * tm, 0.0)
    pdf = num / (jnp.float32(4.0 * np.pi) * f_safe * g)
    return jnp.where(f_ok & (g2 > 0.0), pdf, 0.0)


def bsdf_mis_scale(lights: SphereLights, o_prev, p_hit, prev_pdf_b):
    """MIS weight for lamp emission found BY the BSDF sample.

    ``o_prev``: the previous (lambertian) vertex = the ray origin;
    ``p_hit``: the emissive hit point; ``prev_pdf_b``: the carried
    cosine-pdf of the scatter that produced this ray (0 when the previous
    vertex was not lambertian — callers must pass emission through
    unweighted in that case). The lamp containing ``p_hit`` is identified
    by surface distance over the (small) light table; its cone inv-pdf
    ip = 2 pi (1 - cos_max) from ``o_prev`` gives
        w_B = q / (q + 1),  q = prev_pdf_b * L * ip
    (ip = BIG when o_prev is inside the lamp: the light strategy cannot
    sample there, w_B -> 1 — the bias the suppression scheme had).
    """
    nl = lights.num_lights
    c_all = jnp.asarray(lights.centers)  # [L, 3]
    r_all = jnp.asarray(lights.radii)  # [L]
    # lamp containing p_hit: argmin |dist(p, c_l) - r_l|
    dvec = p_hit[..., None, :] - c_all  # [..., L, 3]
    dist = jnp.sqrt(jnp.sum(dvec * dvec, axis=-1))  # [..., L]
    li = jnp.argmin(jnp.abs(dist - r_all), axis=-1)  # [...]
    c = c_all[li]
    r = r_all[li]
    to_c = c - o_prev
    dist2 = vec.dot(to_c, to_c)
    r2 = r * r
    outside = dist2 > r2 * jnp.float32(1.0 + 1e-6)
    cos_max = jnp.sqrt(
        jnp.maximum(0.0, 1.0 - r2 / jnp.maximum(dist2, 1e-20))
    )
    ip = jnp.where(
        outside, jnp.float32(2.0 * np.pi) * (1.0 - cos_max),
        jnp.float32(1e30),
    )
    q = prev_pdf_b * jnp.float32(nl) * ip
    return q / (q + 1.0)


# ---------------------------------------------------------------------------
# Triangle lamps (emissive mesh faces) — the MeshScene twin of the sphere
# machinery above. Reference point: the reference has no mesh support at
# all (SURVEY §2); this extends the round-2 NEE/MIS design to the mesh
# subsystem so emissive-lit mesh scenes get the same variance behavior as
# sphere/CSG scenes.
# ---------------------------------------------------------------------------


class TriLights(NamedTuple):
    """Struct-of-arrays emissive-triangle list (host-extracted).

    ``normal``/``area`` are precomputed from (e1, e2) so samplers never
    re-derive them: normal = unit cross(e1, e2), area = |cross| / 2.
    Lamps are DOUBLE-SIDED (|cos| in the pdf), matched by the emission
    shading."""

    v0: Array  # [L, 3]
    e1: Array  # [L, 3]
    e2: Array  # [L, 3]
    emit: Array  # [L, 3] radiance
    normal: Array  # [L, 3] unit geometric normal
    area: Array  # [L]

    @property
    def num_lights(self) -> int:
        return self.v0.shape[0]


def extract_mesh_lights(mesh, return_ids: bool = False):
    """Emissive faces of a MeshScene as TriLights, or None if none.

    Host-side numpy, like extract_lights. ``return_ids``: also return
    the lamp faces' indices in ``mesh``'s face ordering."""
    kind = np.asarray(mesh.mat_kind)
    ids = np.where(kind == 4)[0]
    if ids.size == 0:
        return (None, ids) if return_ids else None
    e1 = np.asarray(mesh.e1, np.float32)[ids]
    e2 = np.asarray(mesh.e2, np.float32)[ids]
    cr = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    twoa = np.sqrt((cr * cr).sum(axis=-1))
    lights = TriLights(
        v0=np.asarray(mesh.v0, np.float32)[ids],
        e1=e1,
        e2=e2,
        emit=np.asarray(mesh.albedo, np.float32)[ids],
        normal=(cr / np.maximum(twoa, 1e-30)[:, None]).astype(np.float32),
        area=(0.5 * twoa).astype(np.float32),
    )
    return (lights, ids) if return_ids else lights


def sample_triangle(v0, e1, e2, u1, u2):
    """Uniform area sample of the triangle (v0, v0+e1, v0+e2):
    r = sqrt(u1), barycentrics (1-r, u2 r). Returns [..., 3] points."""
    r = jnp.sqrt(u1)
    bu = (1.0 - r)[..., None]
    bv = (u2 * r)[..., None]
    return v0 + bu * e1 + bv * e2


def nee_contribution_tri(
    hit_fn, p, n, albedo, lights: TriLights, u, pdf_b_fn=None
):
    """MIS-weighted direct light from triangle lamps (area sampling).

    The exact analog of nee_contribution: the light strategy's
    solid-angle density at the sampled direction is
        pdf_L = dist^2 / (|cos_l| * A * L)
    so with the procedural-BRDF fold (BRDF * cos_v = albedo * pdf_b) the
    weighted contribution is  albedo * L_e * q / (1 + q),
    q = pdf_b / pdf_L. Lamps are double-sided (|cos_l|). Occlusion uses
    the same relative tolerance as the sphere path (the sampled point
    lies ON the lamp face, so its own hit lands at ~t_l and never
    occludes)."""
    nl = lights.num_lights
    li = jnp.minimum((u[..., 0] * nl).astype(jnp.int32), nl - 1)
    v0 = jnp.asarray(lights.v0)[li]
    e1 = jnp.asarray(lights.e1)[li]
    e2 = jnp.asarray(lights.e2)[li]
    e = jnp.asarray(lights.emit)[li]
    n_l = jnp.asarray(lights.normal)[li]
    area = jnp.asarray(lights.area)[li]

    q_pt = sample_triangle(v0, e1, e2, u[..., 1], u[..., 2])
    to = q_pt - p
    dist2 = vec.dot(to, to)
    t_l = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    d = to / t_l[..., None]
    cos_v = vec.dot(n, d)
    if pdf_b_fn is None:
        pdf_b = jnp.maximum(cos_v, 0.0) * jnp.float32(1.0 / np.pi)
    else:
        pdf_b = pdf_b_fn(d, cos_v)
    cos_l = jnp.abs(vec.dot(n_l, d))
    sh = hit_fn(p, d)
    occluded = sh.hit & (sh.t < t_l * (1.0 - 1e-4))
    ok = (
        (pdf_b > 0.0) & (cos_l > jnp.float32(1e-6))
        & (dist2 > jnp.float32(1e-12)) & ~occluded
    )
    # q = pdf_b / pdf_L = pdf_b * L * A * |cos_l| / dist^2
    q = pdf_b * jnp.float32(nl) * area * cos_l / jnp.maximum(dist2, 1e-20)
    scale = jnp.where(ok, q / (1.0 + q), 0.0)
    return albedo * e * scale[..., None]


def bsdf_mis_scale_tri(lights: TriLights, o_prev, p_hit, prev_pdf_b):
    """MIS weight for triangle-lamp emission found BY the BSDF sample.

    The lamp containing ``p_hit`` is identified by plane distance +
    barycentric containment over the (small) lamp table; its area pdf
    from ``o_prev`` gives  w_B = q / (q + 1),
    q = prev_pdf_b * L * A * |cos_l| / dist^2  (= pdf_b / pdf_L)."""
    nl = lights.num_lights
    v0a = jnp.asarray(lights.v0)
    n_a = jnp.asarray(lights.normal)
    # lamp containing p_hit: argmin |signed plane distance|
    dvec = p_hit[..., None, :] - v0a  # [..., L, 3]
    pd = jnp.abs(jnp.sum(dvec * n_a, axis=-1))  # [..., L]
    li = jnp.argmin(pd, axis=-1)
    n_l = n_a[li]
    area = jnp.asarray(lights.area)[li]
    to = p_hit - o_prev
    dist2 = vec.dot(to, to)
    t_l = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    d = to / t_l[..., None]
    cos_l = jnp.abs(vec.dot(n_l, d))
    q = (
        prev_pdf_b * jnp.float32(nl) * area * cos_l
        / jnp.maximum(dist2, 1e-20)
    )
    return q / (q + 1.0)


def nee_contribution_any(hit_fn, p, n, albedo, lights, u, pdf_b_fn=None):
    """Type dispatch: SphereLights -> cone sampling, TriLights -> area."""
    if isinstance(lights, TriLights):
        return nee_contribution_tri(
            hit_fn, p, n, albedo, lights, u, pdf_b_fn=pdf_b_fn
        )
    return nee_contribution(hit_fn, p, n, albedo, lights, u,
                            pdf_b_fn=pdf_b_fn)


def bsdf_mis_scale_any(lights, o_prev, p_hit, prev_pdf_b):
    """Type dispatch twin of nee_contribution_any."""
    if isinstance(lights, TriLights):
        return bsdf_mis_scale_tri(lights, o_prev, p_hit, prev_pdf_b)
    return bsdf_mis_scale(lights, o_prev, p_hit, prev_pdf_b)


def extract_scene_lights(scene):
    """Host-side lamps of any scene type: SphereLights for a SphereScene
    or CompiledTape, TriLights for a MeshScene; None if it has none."""
    from ..scene.tape import CompiledTape
    from .trimesh import MeshScene

    if isinstance(scene, MeshScene):
        return extract_mesh_lights(scene)
    if isinstance(scene, CompiledTape):
        return extract_tape_lights(scene)
    return extract_lights(scene)
