"""Demo 7 — triangle meshes, the reference's own "later" milestone.

The reference scopes itself to CSG "with meshes later" (README.md:1-13);
this demo path-traces a triangle-mesh scene (subdivided icospheres + floor
quad, ~1000 faces) through the plain XLA path (MeshScene.nearest_hit).

Run: python demos/demo7_mesh.py --out /tmp/mesh.png
     python demos/demo7_mesh.py --obj model.obj   (render your own mesh)
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from csgrenderer.camera import Camera
from csgrenderer.io import image as image_io
from csgrenderer.render import tonemap
from csgrenderer.render.trimesh import concat_meshes, icosphere, quad
from csgrenderer.scene import Material


def build_scene(subdiv: int = 2, spheres: int = 3):
    """3 icospheres + floor (the demo scene); ``spheres`` > 3 appends
    lambertian spheres behind the hero row — used by the mesh-scale
    sweep to hit face counts between the subdiv rungs (5 spheres at
    subdiv 5 = 102,402 faces, the '100k+' measurement point)."""
    parts = [
        icosphere((-1.1, 0.8, -3.2), 0.8,
                  Material.metal((0.9, 0.8, 0.6), 0.05), subdiv),
        icosphere((1.1, 0.8, -3.0), 0.8, Material.dielectric(1.5), subdiv),
        icosphere((0.0, 0.45, -1.9), 0.45,
                  Material.lambertian((0.2, 0.35, 0.7)), subdiv),
    ]
    extra = [((-2.4, 0.7, -5.2), 0.7, (0.7, 0.3, 0.25)),
             ((2.4, 0.7, -5.4), 0.7, (0.3, 0.6, 0.3)),
             ((0.0, 0.9, -6.3), 0.9, (0.8, 0.7, 0.2)),
             ((-3.4, 0.5, -2.6), 0.5, (0.5, 0.4, 0.7))]
    for c, r, alb in extra[: max(0, spheres - 3)]:
        parts.append(icosphere(c, r, Material.lambertian(alb), subdiv))
    parts.append(
        quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2),
             Material.lambertian((0.55, 0.55, 0.5))))
    return concat_meshes(*parts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--out", default="/tmp/csgr_demo7_mesh.png")
    ap.add_argument("--obj", default=None, help="render an OBJ file instead")
    ap.add_argument("--subdiv", type=int, default=2,
                    help="icosphere subdivision (2 -> 962 faces, "
                    "3 -> 3842, 4 -> 15362)")
    ap.add_argument("--nee", action="store_true",
                    help="night variant: emissive quad lamps + black sky,"
                    " area-sampled TriLights NEE with MIS (round 3b)")
    args = ap.parse_args(argv)

    if args.obj:
        from csgrenderer.io.obj import load_mesh

        mesh = load_mesh(args.obj, Material.lambertian((0.6, 0.6, 0.6)))
    elif args.nee:
        from csgrenderer.models import mesh_night_scene

        mesh = mesh_night_scene(args.subdiv)
    else:
        mesh = build_scene(args.subdiv)
    sky = "black" if args.nee else "rtiow"
    cam = Camera.look_at((0.0, 1.6, 2.2), (0.0, 0.7, -2.6),
                         vfov_degrees=45.0,
                         aspect_ratio=args.width / args.height)

    from csgrenderer.render import render_image
    from csgrenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    lights = None
    if args.nee:
        from csgrenderer.render.lights import extract_mesh_lights

        lights = extract_mesh_lights(mesh)
    img, rays = render_image(
        mesh.nearest_hit, cam, args.width, args.height, spp=args.spp,
        max_bounces=args.bounces, seed=7, sky=sky, lights=lights)
    r = int(rays)
    dt = time.perf_counter() - t0
    out = tonemap.to_uint8(tonemap.tonemap(img, gamma=2.0))
    image_io.write_png(args.out, np.asarray(out))
    print(
        f"[csgr] demo7: {mesh.num_faces} triangles, {args.width}x{args.height}"
        f" spp={args.spp}: {r/dt/1e6:.1f} Mrays/s"
        f" (incl. compile) -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
