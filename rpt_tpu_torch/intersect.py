"""Scene closest hit and occlusion — port of `rpt_tpu/intersect.py`
(`rpt/src/shape/*.rs`).

Every query takes a batch of N rays. Scene-level closest hit is the
reference's deliberate linear scan over objects (`renderer.rs:411-425`),
here a masked min over the analytic prims and the scene's triangles. This
module only composes the kernel layer, whose wrappers route CUDA tensors
to a hand-written kernel and CPU tensors to the plain version beside it:

- the analytic prims: `rpt_tpu_torch.ops.prim_hit` (K-prim, one launch a
  query over every prim of the scene; the per-type chain on the CPU);
- meshes of at most ``DENSE_TRI_ROWS`` packed leaf rows, tested densely
  (every row against the wavefront), as the JAX package does
  (`dense_tri_hit`): `rpt_tpu_torch.ops.dense_tri_hit` (K-dense;
  `dense_tri_hit_plain` on the CPU);
- bigger meshes: the BVH traversal of `rpt_tpu_torch.ops.bvh_traverse`
  (closest hit K1, any hit K2; `_traverse` on the CPU).

The wrappers are reached through their modules at call time (``kernels.``,
``dense.``, ``prim_hit.``), so a caller that replaces one in its module,
or the module here (a benchmark's capture, a test's or the smoke run's
recording), sees every call.
"""

from __future__ import annotations

import torch

from . import tracing
from .dtypes import DTYPE
from .ops import bvh_traverse as kernels
from .ops import dense_tri_hit as dense
from .ops import prim_hit
from .ops.dense_tri_hit import DENSE_TRI_ROWS, finish_hit
from .ray import Hit, Ray


def bvh_closest_hit(bvh, ray: Ray, t_min, best: Hit) -> Hit:
    """Closest triangle hit closer than ``best`` (`rpt_tpu/intersect.py:
    699`, without the TPU's tiled and deferred engines): the dense test for
    tiny meshes (K-dense on a CUDA tensor, `dense_tri_hit_plain` on a CPU
    tensor), else the traversal (K1 on a CUDA tensor, `_traverse` on a CPU
    tensor), then the shading attributes of the winner."""
    if bvh.leaves.shape[0] <= DENSE_TRI_ROWS:
        return dense.dense_closest_hit(bvh, ray, t_min, best)
    time, tri, u, v, w = kernels.bvh_closest_hit(
        bvh, ray.origin.to_array().contiguous(), ray.dir.to_array().contiguous(), t_min,
        best.time.contiguous())
    return finish_hit(bvh, best, time, tri, u, v, w)


def bvh_any_hit(bvh, ray: Ray, t_min, limit, skip=None) -> torch.Tensor:
    """True where some triangle lies at t in [t_min, limit)
    (`rpt_tpu/intersect.py:767`): the early-exit occlusion query (for tiny
    meshes the dense test, K-dense on a CUDA tensor; else K2 on a CUDA
    tensor, `_traverse(any_hit=True)` on a CPU tensor). Lanes in ``skip``
    are already known occluded: both leave them out (their result is
    False)."""
    if bvh.leaves.shape[0] <= DENSE_TRI_ROWS:
        return dense.dense_any_hit(bvh, ray, t_min, limit, skip)
    n = ray.origin.x.shape[0]
    dev = ray.origin.x.device
    limit = torch.as_tensor(limit, dtype=DTYPE, device=dev).expand(n).contiguous()
    return kernels.bvh_any_hit(bvh, ray.origin.to_array().contiguous(),
                               ray.dir.to_array().contiguous(), t_min, limit,
                               None if skip is None else ~skip)


# ---------------------------------------------------------------------------
# Scene-level queries


def _prim_best(scene, tables, ray: Ray, t_min) -> Hit:
    """Closest hit over the analytic primitive batches: K-prim on a CUDA
    tensor, one launch; the per-type chain on a CPU tensor
    (`ops/prim_hit.py`)."""
    return prim_hit.prim_closest_hit(scene.prim_rows, ray, t_min)


def closest_hit(scene, tables, ray: Ray, t_min=None) -> Hit:
    """Masked min over all primitive batches and the triangles — the
    wavefront analog of `Renderer::get_closest_hit` (renderer.rs:416-425).
    Its span, ``intersect.closest``, holds K-prim and K1 or K-dense."""
    if t_min is None:
        t_min = scene.t_min
    with tracing.span("intersect.closest"):
        best = _prim_best(scene, tables, ray, t_min)
        if scene.n_tris:
            best = bvh_closest_hit(tables["bvh"], ray, t_min, best)
    return best


def prim_occluded(scene, tables, ray: Ray, limit, t_min=None) -> torch.Tensor:
    """Occlusion by the analytic primitives only; the mesh is not tested
    (`rpt_tpu/intersect.py:846`): ``_prim_best(...).time < limit``, K-prim's
    any-hit entry on a CUDA tensor. Its span is ``intersect.occluded``."""
    if t_min is None:
        t_min = scene.t_min
    with tracing.span("intersect.occluded"):
        return prim_hit.prim_any_hit(scene.prim_rows, ray, t_min, limit)


def occluded(scene, tables, ray: Ray, limit, t_min=None) -> torch.Tensor:
    """True where any geometry lies at t in [t_min, limit) along the ray —
    the shadow query (lanes with limit -1 are never occluded). Lanes an
    analytic primitive already occludes skip the mesh test. Its span,
    ``intersect.occluded``, holds K-prim and K2 or K-dense."""
    if t_min is None:
        t_min = scene.t_min
    with tracing.span("intersect.occluded"):
        occ = prim_hit.prim_any_hit(scene.prim_rows, ray, t_min, limit)
        if scene.n_tris:
            occ = occ | bvh_any_hit(tables["bvh"], ray, t_min, limit, skip=occ)
    return occ
