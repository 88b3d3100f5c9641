"""CSG tree -> flattened postfix instruction tape (the "missing link").

The reference builds its CSG graph on the host but never ships it to the GPU
(SURVEY.md §0; the shader hard-codes one sphere). This module is the
wired-together version demanded by BASELINE.json's north star: a compiler
from the SceneGraph to a device-consumable program.

Split of static vs dynamic state (the core design decision):

- **Static (pytree aux, fixed at trace time):** the postfix opcode stream,
  leaf primitive types, and each leaf's chain of edges up to the root.
  Changing scene *topology* recompiles — exactly like a shader rebuild.
- **Dynamic (pytree leaves, jit arguments):** leaf parameters, per-edge
  orientation quaternions + offsets, baked world->local leaf transforms, and
  materials. Animated scenes (BASELINE config 5's time-varying transforms)
  update edge arrays and call ``rebake()`` *inside* jit — zero recompiles
  per frame.

Edge transform semantics (``Wo_Node_Argument``, renderer.h:22-27): a child is
placed in its parent's frame by ``p_parent = rotate(q_edge, p_child) +
offset_edge``. The compiler composes these root-to-leaf and stores, per leaf,
the world->local quaternion ``leaf_rot`` and world-space origin ``leaf_pos``
so the evaluator computes ``p_local = rotate(leaf_rot, p - leaf_pos)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..math import quaternion as quat
from .graph import BINOP_TYPES, LEAF_TYPES, NodeType, SceneGraph

# Opcodes
OP_PUSH = 0
OP_UNION = 1
OP_INTERSECT = 2
OP_DIFF = 3

_BINOP_OPCODE = {
    NodeType.UNION_OF: OP_UNION,
    NodeType.INTERSECTION_OF: OP_INTERSECT,
    NodeType.DIFFERENCE_OF: OP_DIFF,
}


@jax.tree_util.register_pytree_node_class
class CompiledTape:
    """Flattened CSG program + device arrays. See module docstring."""

    def __init__(
        self,
        ops,
        leaf_types,
        leaf_chains,
        k,
        stack_depth,
        leaf_params,
        edge_quat,
        edge_off,
        leaf_rot,
        leaf_pos,
        mat_kind,
        albedo,
        mat_param,
    ):
        # static
        self.ops = tuple(ops)  # tuple[(opcode, operand)]
        self.leaf_types = tuple(int(t) for t in leaf_types)
        self.leaf_chains = tuple(tuple(c) for c in leaf_chains)
        self.k = int(k)
        self.stack_depth = int(stack_depth)
        # dynamic
        self.leaf_params = leaf_params  # [L, 4] f32
        self.edge_quat = edge_quat  # [E, 4] f32 (local -> parent)
        self.edge_off = edge_off  # [E, 3] f32
        self.leaf_rot = leaf_rot  # [L, 4] f32 (world -> local)
        self.leaf_pos = leaf_pos  # [L, 3] f32 (leaf origin, world)
        self.mat_kind = mat_kind  # [L] int32
        self.albedo = albedo  # [L, 3] f32
        self.mat_param = mat_param  # [L] f32

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_types)

    def tree_flatten(self):
        children = (
            self.leaf_params,
            self.edge_quat,
            self.edge_off,
            self.leaf_rot,
            self.leaf_pos,
            self.mat_kind,
            self.albedo,
            self.mat_param,
        )
        aux = (self.ops, self.leaf_types, self.leaf_chains, self.k, self.stack_depth)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        ops, leaf_types, leaf_chains, k, stack_depth = aux
        return cls(ops, leaf_types, leaf_chains, k, stack_depth, *children)

    # -- animation support ---------------------------------------------------
    def rebake(self) -> "CompiledTape":
        """Recompute leaf world->local transforms from edge arrays (jit-safe).

        Each leaf's static edge chain is unrolled; composition is pure jnp so
        this runs inside a jitted frame function for animated scenes.
        """
        rots, poss = [], []
        for chain in self.leaf_chains:
            q = jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)
            t = jnp.zeros((3,), jnp.float32)
            for e in chain:  # root-to-leaf order
                t = quat.rotate(q, self.edge_off[e]) + t
                q = quat.multiply(q, self.edge_quat[e])
            rots.append(quat.conjugate(q))
            poss.append(t)
        leaf_rot = jnp.stack(rots) if rots else jnp.zeros((0, 4), jnp.float32)
        leaf_pos = jnp.stack(poss) if poss else jnp.zeros((0, 3), jnp.float32)
        return CompiledTape(
            self.ops, self.leaf_types, self.leaf_chains, self.k, self.stack_depth,
            self.leaf_params, self.edge_quat, self.edge_off,
            leaf_rot, leaf_pos, self.mat_kind, self.albedo, self.mat_param,
        )

    def with_edges(self, edge_quat: Array, edge_off: Array) -> "CompiledTape":
        """New tape with replaced edge transforms, re-baked (jit-safe)."""
        t = CompiledTape(
            self.ops, self.leaf_types, self.leaf_chains, self.k, self.stack_depth,
            self.leaf_params, edge_quat, edge_off,
            self.leaf_rot, self.leaf_pos, self.mat_kind, self.albedo, self.mat_param,
        )
        return t.rebake()


def compile_tape(graph: SceneGraph, root: int, k: int = 8) -> CompiledTape:
    """Post-order flatten of ``root``'s subtree into a CompiledTape."""
    ops: list[tuple[int, int]] = []
    leaf_types: list[int] = []
    leaf_params: list[list[float]] = []
    leaf_chains: list[tuple[int, ...]] = []
    mats: list = []
    edge_quat: list = []
    edge_off: list = []

    def walk(node: int, chain: tuple[int, ...], depth: int) -> None:
        # cycle guard: any true tree's depth is < its node count (union
        # CHAINS of hundreds of objects are legitimate, models.
        # many_objects_scene)
        if depth > graph.node_count:
            raise RecursionError("CSG tree too deep (cycle?)")
        ntype = graph.node_type[node]
        info = graph.node_info[node]
        if ntype in LEAF_TYPES:
            leaf_idx = len(leaf_types)
            leaf_types.append(int(ntype))
            leaf_params.append(_pack_params(ntype, info))
            leaf_chains.append(chain)
            mats.append(graph.material[node])
            ops.append((OP_PUSH, leaf_idx))
        elif ntype in BINOP_TYPES:
            left, right = info
            for arg in (left, right):
                e = len(edge_quat)
                edge_quat.append(list(arg.orientation))
                edge_off.append(list(arg.offset))
                walk(arg.node, chain + (e,), depth + 1)
            ops.append((_BINOP_OPCODE[ntype], 0))
        else:  # pragma: no cover
            raise ValueError(f"unknown node type {ntype}")

    walk(root, (), 0)

    # simulate stack to find depth
    depth = max_depth = 0
    for opcode, _ in ops:
        depth = depth + 1 if opcode == OP_PUSH else depth - 1
        max_depth = max(max_depth, depth)
    if depth != 1:
        raise AssertionError("malformed tape")

    L = len(leaf_types)
    E = len(edge_quat)
    tape = CompiledTape(
        ops=ops,
        leaf_types=leaf_types,
        leaf_chains=leaf_chains,
        k=k,
        stack_depth=max_depth,
        leaf_params=jnp.asarray(
            np.asarray(leaf_params, np.float32).reshape(L, 4)
        ),
        edge_quat=jnp.asarray(
            np.asarray(edge_quat, np.float32).reshape(E, 4)
            if E
            else np.zeros((0, 4), np.float32)
        ),
        edge_off=jnp.asarray(
            np.asarray(edge_off, np.float32).reshape(E, 3)
            if E
            else np.zeros((0, 3), np.float32)
        ),
        leaf_rot=jnp.zeros((L, 4), jnp.float32),
        leaf_pos=jnp.zeros((L, 3), jnp.float32),
        mat_kind=jnp.asarray([m.kind for m in mats], jnp.int32),
        albedo=jnp.asarray([list(m.albedo) for m in mats], jnp.float32).reshape(L, 3),
        mat_param=jnp.asarray([m.param for m in mats], jnp.float32),
    )
    return tape.rebake()


def _pack_params(ntype: NodeType, info) -> list[float]:
    """Leaf params -> fixed [4] layout."""
    p = [0.0, 0.0, 0.0, 0.0]
    if ntype == NodeType.SPHERE:
        p[0] = info[0]
    elif ntype == NodeType.INFINITE_PLANAR_PARTITION:
        n = np.asarray(info[:3], np.float64)
        n = n / max(float(np.linalg.norm(n)), 1e-12)
        p[:3] = n.tolist()
    elif ntype == NodeType.BOX:
        p[:3] = list(info[:3])
    elif ntype == NodeType.CYLINDER:
        p[0], p[1] = info[0], info[1]
    return p
