"""Pallas-Triton path-tracing kernels (sphere soups and CSG tapes)."""

from .megakernel import pack_scene, render_image_pallas
from .tape_kernel import render_image_tape_pallas

__all__ = [
    "pack_scene",
    "render_image_pallas",
    "render_image_tape_pallas",
]
