"""Multi-device execution on ``torch.distributed``: pixel and sample
sharding over a (dp, sp) device mesh — port of `rpt_tpu/parallel.py`.

The JAX package runs one process over a mesh with ``shard_map``. The
PyTorch idiom is one process a device, every rank calling the same
function (SPMD) over an initialised default process group: NCCL on the
card, gloo on the CPU. Ranks lie on the mesh as JAX lays devices out,
rank = dp_index * sp + sp_index.

* **dp**: blocks of pixels (raster order, padded to a multiple of dp),
  each traced in Morton lane order. The scene is replicated.
* **sp**: samples; rank ``sp_index`` traces the global sample indices
  ``sp_index * local + s``. The per-pixel sums meet in an ``all_reduce``
  over sp, the blocks in an ``all_gather`` over dp.
* **photons**: the photon index splits over every rank, each shooting
  from ``fold_in(key, rank)``; the deposits are gathered in rank order.

Keys fold by the global pixel id and the global sample index, so a
render is the same for every (dp, sp) up to the order of the sums. One
rank traces the lanes of the single-process pass (`renderer._path_pass`,
`renderer._photon_pass`) in their order, so for the same key it gives the
same sums: K-sweep splits a ray's sum at its blocks of 256 lanes, and the
lane order reaches the last bit of a point-beam estimate. Every function
returns the same host numpy arrays on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import sampling
from .dtypes import resolve_device
from .ray import Ray
from .renderer import PATH_CHUNK, PIXEL_CHUNK, _morton2, camera_rays


def make_mesh(n_devices: int | None = None, sp: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (dp, sp) `DeviceMesh` with dimensions named ``("dp", "sp")`` over
    the initialised default process group (NCCL on the card, gloo on the
    CPU): one rank a device. The card unless the caller asks for
    ``"cpu"``. Raises where no process group is initialised, the card is
    missing, the world size is not ``n_devices`` (None: the world size),
    or ``sp`` does not divide it."""
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else int(n_devices)
    if n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) over a world of {world} ranks")
    if sp < 1 or n_devices % sp:
        raise ValueError(f"sp={sp} does not divide {n_devices} devices")
    return init_device_mesh(device_type, (n_devices // sp, sp), mesh_dim_names=("dp", "sp"))


def _split(scene, mesh: DeviceMesh, num_samples: int):
    """(dp, sp, dp index, sp index) of this rank; raises where the
    samples do not divide over sp or the scene lies on another device
    type than the mesh."""
    dp, sp = mesh.size(0), mesh.size(1)
    if num_samples % sp:
        raise ValueError(f"num_samples={num_samples} does not divide over sp={sp}")
    if scene.device.type != mesh.device_type:
        raise ValueError(f"the scene is on {scene.device}, the mesh on {mesh.device_type}")
    return dp, sp, mesh.get_local_rank("dp"), mesh.get_local_rank("sp")


def _pixel_block(width: int, height: int, dp: int, dp_index: int):
    """This rank's block of the raster pixel ids, padded to a multiple of
    dp (the padding's ids lie past the image and are traced, then
    stripped), its lanes in Morton order as `renderer._pixel_grid` lays a
    wavefront out, so a one-rank pass traces `_path_pass`'s and
    `_photon_pass`'s lanes: ``(xn, yn, ids, inv)``, NDC in float64
    (renderer.rs:174-176) and ``inv[i]`` the lane of the block's i-th
    pixel."""
    n_padded = -(-width * height // dp) * dp
    block = n_padded // dp
    xs = np.arange(dp_index * block, (dp_index + 1) * block, dtype=np.int64)
    px, py = xs % width, xs // width
    perm = np.argsort(_morton2(px, py), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(block)
    dim = float(max(width, height))
    xn = (2.0 * px[perm].astype(np.float64) + 1.0 - width) / dim
    yn = (2.0 * (height - py[perm]).astype(np.float64) - 1.0 - height) / dim
    return xn, yn, xs[perm], inv


def _reduce(total: torch.Tensor, inv, mesh: DeviceMesh, n_pix: int) -> np.ndarray:
    """This rank's lanes back in raster order (``inv``), the blocks summed
    over sp and gathered over dp: the (n_pix, 3) float32 sum on every
    rank, padding stripped."""
    total = total[torch.as_tensor(inv, device=total.device)].contiguous()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.get_group("sp"))
    blocks = [torch.empty_like(total) for _ in range(mesh.size(0))]
    dist.all_gather(blocks, total, group=mesh.get_group("dp"))
    return torch.cat(blocks)[:n_pix].cpu().numpy()


def render_sharded(scene, camera, width: int, height: int, num_samples: int,
                   max_bounces: int, mesh: DeviceMesh, key, media_max_depth: int = 32):
    """Path trace with pixels sharded over dp and samples over sp
    (`rpt_tpu/parallel.py:44-99`): `trace_volumetric` where the scene has a
    medium, else `trace_surface`, in `PATH_CHUNK`-lane pieces. Returns the
    (H*W, 3) float32 radiance *sum* over ``num_samples`` (host numpy, the
    same on every rank)."""
    from .integrators.path import trace_surface, trace_volumetric

    dp, sp, dp_index, sp_index = _split(scene, mesh, num_samples)
    xn, yn, ids, inv = _pixel_block(width, height, dp, dp_index)
    dim, n, local = float(max(width, height)), ids.shape[0], num_samples // sp
    total = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
    for s in range(sp_index * local, (sp_index + 1) * local):
        ray, keys = camera_rays(scene, camera, dim, xn, yn, ids, key, s)
        trace_keys = sampling.fold(keys, 4)
        for c in range(0, n, PATH_CHUNK):
            sl = slice(c, min(c + PATH_CHUNK, n))
            piece = Ray(ray.origin[sl], ray.dir[sl])
            if scene.media:
                color = trace_volumetric(scene, scene.tables, piece, trace_keys[sl],
                                         media_max_depth)
            else:
                color = trace_surface(scene, scene.tables, piece, trace_keys[sl], max_bounces)
            total[sl] += color.to_array()
    return _reduce(total, inv, mesh, width * height)


def photon_render_sharded(scene, camera, width: int, height: int, num_samples: int, pmap,
                          kind: str, gather_size: int, gather_size_volume: int,
                          mesh: DeviceMesh, key, occlusion_check: bool = True):
    """The photon-map camera pass with pixels sharded over dp and samples
    over sp, the map ``pmap`` (`integrators.photon.build_photon_map`, of
    kind ``kind``) replicated (`rpt_tpu/parallel.py:102-159`):
    `estimate_indirect` in wavefronts of `PIXEL_CHUNK` lanes, as
    `_photon_pass` runs it. Returns the (H*W, 3) float32 radiance *sum*
    (host numpy, the same on every rank)."""
    from .integrators.photon import estimate_indirect

    if pmap.kind != kind:
        raise ValueError(f"a {pmap.kind} map given for a {kind} pass")
    dp, sp, dp_index, sp_index = _split(scene, mesh, num_samples)
    xn, yn, ids, inv = _pixel_block(width, height, dp, dp_index)
    dim, n, local = float(max(width, height)), ids.shape[0], num_samples // sp
    total = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
    for s in range(sp_index * local, (sp_index + 1) * local):
        ray, keys = camera_rays(scene, camera, dim, xn, yn, ids, key, s)
        ekeys = sampling.fold(keys, 4)
        for c in range(0, n, PIXEL_CHUNK):
            sl = slice(c, min(c + PIXEL_CHUNK, n))
            color = estimate_indirect(scene, scene.tables, pmap, Ray(ray.origin[sl], ray.dir[sl]),
                                      ekeys[sl], gather_size, gather_size_volume,
                                      occlusion_check)
            total[sl] += color.to_array()
    return _reduce(total, inv, mesh, width * height)


def _gather_rows(rows: torch.Tensor) -> np.ndarray:
    """Every rank's rows, in rank order: the counts first, then the rows
    padded to the largest count (gloo and NCCL gather equal shapes)."""
    world = dist.get_world_size()
    count = torch.tensor([rows.shape[0]], dtype=torch.int64, device=rows.device)
    counts = [torch.empty_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    padded = rows.new_zeros((max(max(counts), 1), rows.shape[1]))
    padded[: rows.shape[0]] = rows
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).cpu().numpy()


def shoot_photons_sharded(scene, key, photon_count: int, watts: float, kind: str,
                          mesh: DeviceMesh, max_depth: int = 48):
    """Photon shooting sharded by photon index over every rank of the mesh
    (`rpt_tpu/parallel.py:162-203`; rayon's parallel photon loop,
    photon.rs:663-674): each rank runs one launch of ``ceil(photon_count /
    n_dev)`` photons from ``fold_in(key, rank)``, at the power of the
    ``n_dev * per_dev`` photons emitted in all, its rows clipped at the
    capacities. ``kind`` is the JAX signature's; the shoot is the same for
    every kind. Returns ``(surface, volume)`` float32 host arrays, the
    ranks' rows in rank order."""
    from .integrators.photon import _find_object_light, _shoot_launch

    if scene.device.type != mesh.device_type:
        raise ValueError(f"the scene is on {scene.device}, the mesh on {mesh.device_type}")
    n_dev = mesh.size()
    dp_index, sp_index = mesh.get_coordinate()
    rank = dp_index * mesh.size(1) + sp_index
    per_dev = -(-photon_count // n_dev)
    li, _ = _find_object_light(scene)
    surface, volume, _ = _shoot_launch(scene, scene.tables, li, watts / (n_dev * per_dev),
                                       max_depth, per_dev, sampling.fold_in(key, rank))
    return _gather_rows(surface), _gather_rows(volume)
