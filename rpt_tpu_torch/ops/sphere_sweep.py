"""Beam-query x point-photon sphere sweep — port of the Pallas kernel
`rpt_tpu/ops/sphere_sweep.py::sphere_sweep` (K3).

For each camera ray, the sum over every photon sphere it pierces before
its surface hit of ``(3/pi)(1 - d^2/r^2)^2 / r^2 * exp(-ext*dd) *
phase_const * power``, times the medium colour. Spheres arrive as the
JAX package's field-major ``(FIELDS, P)`` table (`pack_spheres_transposed`),
P padded with zero-radius (inert) spheres.

The kernel (`csrc/sphere_sweep.cu`, K-sweep) reads a kernel-side table
built once per photon map (`build_sphere_table`): the spheres reordered
along a 3-D Morton curve of their centres, as 32-byte records in tiles
of TILE spheres, each tile with a bound (the box of its centres and
its largest radius). Every 256 consecutive rays keep only the tiles that
one of their segments can reach (`tile_keep_plain` is the plain version
of that test) and sweep only those.

`sphere_sweep` is the wrapper: for tensors on the CPU it runs
`sphere_sweep_plain`, a chunked dense sweep in torch ops; for CUDA tensors
it launches K-sweep on a `SphereTable` or raises. `pierced_count` counts
the pierced pairs of each ray through the same cull and test, for
verification only (`pierced_count_plain` is its plain version).
`sphere_sweep_phase` is the sweep for media whose phase is no constant:
torch ops on every device, as it is XLA in the JAX package.
`_build.launch` counts each launch under its wrapper's name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _build

SPHERE_CHUNK = 512
# transposed sphere table rows: px py pz radius dirx diry dirz powx powy powz
FIELDS = 10
TILE = 256  # spheres per tile of the kernel-side table (kTile in the .cu)
RAYS = 256  # rays per ray block: the unit the kernel keeps tiles for
MAX_BLOCKS_PER_SM = 16  # sweep blocks of 128 threads that fit one SM
RECORD = 8  # floats per kernel-side record: px py pz r2' | wx wy wz 0

# The cull's rounding allowances (sphere_sweep.cu, "The cull"): the unit
# roundoff of float32 and the relative slack of the approximate square
# root the kernel takes for bounds.
U = 2.0**-24
SQRT_UP = 1.0 + 1e-5


def pack_spheres_transposed(pos, radius, direction, power) -> torch.Tensor:
    """(FIELDS, P) f32 sphere table on the inputs' device, P padded to a
    multiple of SPHERE_CHUNK with zero-radius (inert) spheres
    (`rpt_tpu/ops/sphere_sweep.py:135`). ``pos``/``direction``/``power``
    are (n, 3) tensors, ``radius`` (n,)."""
    n = radius.shape[0]
    p = max(SPHERE_CHUNK, -(-n // SPHERE_CHUNK) * SPHERE_CHUNK)
    out = torch.zeros((FIELDS, p), dtype=torch.float32, device=radius.device)
    out[0:3, :n] = pos.T
    out[3, :n] = radius
    out[4:7, :n] = direction.T
    out[7:10, :n] = power.T
    return out


# ---------------------------------------------------------------------------
# The kernel-side table


@dataclass
class SphereTable:
    """The sphere table K-sweep reads, built once per photon map.

    ``spheres_t``: the (FIELDS, P) table in Morton order (what
    `sphere_sweep_plain` takes); ``records``: (n_tiles * TILE, RECORD) f32,
    one 32-byte record per sphere, ``(px, py, pz, r2' | wx, wy, wz, 0)``
    with ``r2' = max(rad*rad, 1e-30)`` for ``rad > 0`` and -1 otherwise,
    the last tile padded with inert records; ``bounds``: (n_tiles, 8) f32,
    ``(lo xyz, largest radius | hi xyz, 0)`` of each tile's centres;
    ``order``: the sphere of the input table behind each record."""

    spheres_t: torch.Tensor
    records: torch.Tensor
    bounds: torch.Tensor
    order: torch.Tensor
    n_spheres: int

    @property
    def n_tiles(self) -> int:
        return self.bounds.shape[0]


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """10-bit integers with two zero bits inserted after every bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_order(pos: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts (n, 3) points along a 3-D Morton curve
    of 10 bits per axis over their bounding box (stable: ties keep their
    order)."""
    if pos.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=pos.device)
    lo = pos.min(dim=0).values
    extent = torch.clamp(pos.max(dim=0).values - lo, min=1e-30)
    q = torch.clamp(((pos - lo) * (1024.0 / extent)).long(), 0, 1023)
    code = (_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1) | _spread3(q[:, 2])
    return torch.argsort(code, stable=True)


def build_sphere_table(spheres_t: torch.Tensor, n_spheres: int) -> SphereTable:
    """K-sweep's table of the first ``n_spheres`` spheres of a
    `pack_spheres_transposed` table, on its device."""
    n = min(int(n_spheres), spheres_t.shape[1])
    dev = spheres_t.device
    order = morton_order(spheres_t[0:3, :n].T)
    ordered = torch.zeros_like(spheres_t)
    ordered[:, :n] = spheres_t[:, :n][:, order]

    n_tiles = -(-n // TILE)
    rad = ordered[3, :n]
    records = torch.zeros((n_tiles * TILE, RECORD), dtype=torch.float32, device=dev)
    records[:, 3] = -1.0
    records[:n, 0:3] = ordered[0:3, :n].T
    # the plain version's r2 (clamp of the rounded rad*rad); -1 where it
    # asks rad > 0, which no dist2 >= 0 passes
    records[:n, 3] = torch.where(rad > 0.0, torch.clamp(rad * rad, min=1e-30), -1.0)
    records[:n, 4:7] = ordered[7:10, :n].T

    pos = records[:, 0:3].reshape(n_tiles, TILE, 3)
    real = (torch.arange(n_tiles * TILE, device=dev) < n).reshape(n_tiles, TILE, 1)
    bounds = torch.zeros((n_tiles, 8), dtype=torch.float32, device=dev)
    bounds[:, 0:3] = torch.where(real, pos, math.inf).amin(dim=1)
    bounds[:, 4:7] = torch.where(real, pos, -math.inf).amax(dim=1)
    r = torch.zeros(n_tiles * TILE, dtype=torch.float32, device=dev)
    r[:n] = torch.clamp(rad, min=0.0)
    bounds[:, 3] = r.reshape(n_tiles, TILE).amax(dim=1)
    return SphereTable(ordered, records, bounds, order, n)


# ---------------------------------------------------------------------------
# Plain versions


def _pierce(sph, ox, oy, oz, dx, dy, dz, th):
    """The pierce test of every (ray, sphere) pair of a chunk, as K-sweep
    decides it: ``(ok, dd, dist2, r2)``, (rays, spheres) each."""
    ocx = sph[0][None, :] - ox
    ocy = sph[1][None, :] - oy
    ocz = sph[2][None, :] - oz
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    dd = ocx * dx + ocy * dy + ocz * dz
    dist2 = torch.clamp(oc2 - dd * dd, min=0.0)
    rad = sph[3][None, :]
    r2 = torch.clamp(rad * rad, min=1e-30)
    ok = (dd > 0.0) & (dist2 < r2) & (torch.sqrt(oc2) <= th) & (rad > 0.0)
    return ok, dd, dist2, r2


def _chunks(ray_o, ray_d, hit_time, spheres_t, n_spheres):
    """(pierce test, sphere chunk) over the first ``n_spheres`` spheres in
    chunks that bound the (rays, chunk) temporaries."""
    n = ray_o.shape[0]
    p = min(int(n_spheres), spheres_t.shape[1])
    chunk = max(256, (1 << 26) // max(n, 1))
    o = [ray_o[:, i : i + 1] for i in range(3)]
    d = [ray_d[:, i : i + 1] for i in range(3)]
    for s in range(0, p, chunk):
        sph = spheres_t[:, s : min(s + chunk, p)]
        yield _pierce(sph, *o, *d, hit_time[:, None]), sph


def sphere_sweep_plain(ray_o, ray_d, hit_time, spheres_t, ext: float, med_color,
                       n_spheres: int, phase_const: float) -> torch.Tensor:
    """Plain torch version: dense (rays, chunk) pair math, reduced per
    chunk by an FP32 matrix product (TF32 is off, `dtypes.py`)."""
    scale = float(phase_const) * 3.0 / math.pi
    acc = torch.zeros((ray_o.shape[0], 3), dtype=torch.float32, device=ray_o.device)
    for (ok, dd, dist2, r2), sph in _chunks(ray_o, ray_d, hit_time, spheres_t, n_spheres):
        x = dist2 / r2
        k2 = (1.0 - x) * (1.0 - x)
        w = torch.where(ok, k2 / r2 * torch.exp(-ext * dd) * scale, 0.0)
        acc = acc + w @ sph[7:10].T
    return acc * med_color[None, :]


def sphere_sweep_phase(ray_o, ray_d, hit_time, spheres_t, ext: float, med_color,
                       n_spheres: int, phase) -> torch.Tensor:
    """The sweep for a medium whose phase depends on the directions, in
    torch ops on any device: the JAX package's chunked XLA sweep
    (`rpt_tpu/integrators/photon.py:669-718`), which its Pallas kernel does
    not serve either. ``phase(photon_dir, ray_dir)`` takes two triples of
    broadcastable (rays, chunk) components and returns the phase value of
    every pair."""
    acc = torch.zeros((ray_o.shape[0], 3), dtype=torch.float32, device=ray_o.device)
    d = tuple(ray_d[:, i : i + 1] for i in range(3))
    for (ok, dd, dist2, r2), sph in _chunks(ray_o, ray_d, hit_time, spheres_t, n_spheres):
        x = dist2 / r2
        k2 = (3.0 / math.pi) * (1.0 - x) * (1.0 - x)
        ph = phase(tuple(sph[4 + i][None, :].expand_as(dd) for i in range(3)),
                   tuple(c.expand_as(dd) for c in d))
        w = torch.where(ok, k2 / r2 * ph * torch.exp(-ext * dd), 0.0)
        acc = acc + w @ sph[7:10].T
    return acc * med_color[None, :]


def pierced_count_plain(ray_o, ray_d, hit_time, spheres_t, n_spheres: int) -> torch.Tensor:
    """Plain torch version of `pierced_count`: the number of spheres each
    ray pierces, (N,) int64."""
    count = torch.zeros(ray_o.shape[0], dtype=torch.int64, device=ray_o.device)
    for (ok, *_), _sph in _chunks(ray_o, ray_d, hit_time, spheres_t, n_spheres):
        count += ok.sum(dim=1)
    return count


def sqrt_threshold(hit_time: torch.Tensor) -> torch.Tensor:
    """Per ray the largest float32 ``th2`` with ``sqrt(th2) <= hit_time``,
    so that ``oc2 <= th2`` decides every pair exactly as ``sqrt(oc2) <=
    hit_time``: NaN stays NaN, a negative limit gives -1 (no ``oc2 >= 0``
    passes). K-sweep computes it the same way, once per ray."""
    th = hit_time
    x = torch.where(th >= 0.0, th * th, torch.where(torch.isnan(th), th, -1.0))
    live = th >= 0.0
    zero, inf = torch.zeros_like(x), torch.full_like(x, math.inf)
    while True:  # down until sqrt(x) <= th
        down = live & (torch.sqrt(x) > th)
        if not bool(down.any()):
            break
        x = torch.where(down, torch.nextafter(x, zero), x)
    while True:  # up while the next float still passes
        nxt = torch.nextafter(x, inf)
        up = live & (x < math.inf) & (torch.sqrt(nxt) <= th)
        if not bool(up.any()):
            return x
        x = torch.where(up, nxt, x)


def record_pierce_plain(records, ray_o, ray_d, hit_time) -> torch.Tensor:
    """(N, R) bool: K-sweep's decision on every (ray, record) pair, ``dd >
    0 and dist2 < r2' and oc2 <= th2`` in the plain version's rounded
    operations. It equals `_pierce`'s ``ok`` on the same spheres."""
    th2 = sqrt_threshold(hit_time)[:, None]
    o = [ray_o[:, i : i + 1] for i in range(3)]
    d = [ray_d[:, i : i + 1] for i in range(3)]
    ocx, ocy, ocz = (records[None, :, i] - o[i] for i in range(3))
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    dd = ocx * d[0] + ocy * d[1] + ocz * d[2]
    dist2 = torch.clamp(oc2 - dd * dd, min=0.0)
    return (dd > 0.0) & (dist2 < records[None, :, 3]) & (oc2 <= th2)


def tile_keep_plain(ray_o, ray_d, hit_time, table: SphereTable) -> torch.Tensor:
    """(N, n_tiles) bool: the tiles each ray keeps, the plain version of
    K-sweep's cull (sphere_sweep.cu, "The cull"). The ray's segment ``o +
    t d``, ``t`` in ``[-8u |oc|max / |d|, hit_time (1 + 16u) / |d|]``, must
    meet the box of the tile's centres inflated by ``R``: the largest
    radius grown by the float32 error of ``oc2 - dd*dd`` at the tile's
    farthest centre and by the slab test's own rounding. A NaN slab bound
    (0 * inf) does not constrain."""
    dx, dy, dz = ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3]
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
    dn2 = dx * dx + dy * dy + dz * dz
    inv_len = (1.0 + 16 * U) / torch.sqrt(dn2)
    eterm = (32 * U * torch.clamp(dn2, min=1.0) + torch.clamp(dn2 - 1.0, min=0.0)
             + 8 * U * dn2)
    th = hit_time[:, None]
    tcap = torch.where(th >= 0.0, th * (1.0 + 16 * U) * inv_len, -math.inf)
    oinf = ray_o.abs().amax(dim=1, keepdim=True)
    lo, hi, rmax = (table.bounds[None, :, 0:3], table.bounds[None, :, 4:7],
                    table.bounds[None, :, 3])
    o = (ox, oy, oz)
    ax, ay, az = (torch.fmax((lo[..., i] - o[i]).abs(), (hi[..., i] - o[i]).abs())
                  for i in range(3))
    om2 = ax * ax + ay * ay + az * az
    om = torch.sqrt(om2) * SQRT_UP
    rc = torch.sqrt(eterm * om2 + (rmax * rmax * (1.0 + 8 * U) + 1e-30)) * SQRT_UP
    big_r = rc + 16 * U * (oinf + om + rc)
    enter = -8 * U * om * inv_len
    exit_ = tcap.expand_as(enter)
    for i, inv in enumerate((1.0 / dx, 1.0 / dy, 1.0 / dz)):
        t1 = ((lo[..., i] - big_r) - o[i]) * inv
        t2 = ((hi[..., i] + big_r) - o[i]) * inv
        nan = torch.isnan(t1) | torch.isnan(t2)
        enter = torch.fmax(enter, torch.where(nan, -math.inf, torch.fmin(t1, t2)))
        exit_ = torch.fmin(exit_, torch.where(nan, math.inf, torch.fmax(t1, t2)))
    return enter <= exit_


# ---------------------------------------------------------------------------
# Wrappers


def _check_args(ray_o, ray_d, hit_time, spheres, med_color=None):
    n = ray_o.shape[0]
    checks = [("ray_o", ray_o, (n, 3)), ("ray_d", ray_d, (n, 3)), ("hit_time", hit_time, (n,))]
    if med_color is not None:
        checks.append(("med_color", med_color, (3,)))
    for name, t, shape in checks:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"sphere_sweep: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != ray_o.device:
            raise ValueError(f"sphere_sweep: {name} is on {t.device}, rays on {ray_o.device}")
    table = spheres.spheres_t if isinstance(spheres, SphereTable) else spheres
    if table.dim() != 2 or table.shape[0] != FIELDS or table.dtype != torch.float32:
        raise ValueError(f"sphere_sweep: spheres_t must be float32 ({FIELDS}, P)")
    if table.device != ray_o.device:
        raise ValueError("sphere_sweep: the sphere table is not on the rays' device")


def _check_kernel_table(ray_o, spheres, n_spheres: int) -> None:
    """What a CUDA call needs beyond `_check_args`: the kernel-side table,
    whole and consistent with ``n_spheres``. Raises otherwise."""
    _build.on_card("sphere_sweep", ray_o)
    if not isinstance(spheres, SphereTable):
        raise ValueError("sphere_sweep: a CUDA call needs the kernel-side SphereTable "
                         "(build_sphere_table), not the bare (FIELDS, P) table")
    if int(n_spheres) != spheres.n_spheres:
        raise ValueError(f"sphere_sweep: n_spheres {n_spheres} differs from the table's "
                         f"{spheres.n_spheres}")
    if (spheres.records.shape != (spheres.n_tiles * TILE, RECORD)
            or spheres.bounds.shape != (spheres.n_tiles, 8)
            or spheres.records.device != ray_o.device or spheres.bounds.device != ray_o.device):
        raise ValueError("sphere_sweep: malformed SphereTable")
    if spheres.n_spheres >= 1 << 24:
        raise ValueError("sphere_sweep: 2^24 spheres or more (per-ray counts are exact in "
                         "float32 only below that)")
    if -(-ray_o.shape[0] // RAYS) * spheres.n_tiles >= 1 << 31:
        raise ValueError("sphere_sweep: too many (ray block, tile) pairs for int32 lists")


def _launch(name: str, entry: str, ray_o, ray_d, hit_time, table: SphereTable, args: tuple,
            out):
    """Launch one of the two entry points of `csrc/sphere_sweep.cu` with
    its workspace for the wrapper ``name``; ``args`` are the entry's own
    arguments between the table and the workspace. Returns the offsets of
    each ray block's kept tiles in the work list, (n_rb + 1,) int32."""
    n = ray_o.shape[0]
    n_rb = -(-n // RAYS)
    dev = ray_o.device
    max_blocks = MAX_BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    keep = torch.empty(n_rb * table.n_tiles, dtype=torch.uint8, device=dev)
    lists = torch.empty(n_rb * table.n_tiles, dtype=torch.int32, device=dev)
    counts = torch.empty(2 * n_rb + 1, dtype=torch.int32, device=dev)  # counts | offsets
    width = 3 if out.dim() == 2 else 1
    partial = torch.empty((max_blocks + n_rb) * RAYS * width, dtype=torch.float32, device=dev)
    ray_o, ray_d, hit_time = ray_o.contiguous(), ray_d.contiguous(), hit_time.contiguous()
    _build.launch(name, entry, ray_o, ray_o.data_ptr(), ray_d.data_ptr(), hit_time.data_ptr(),
                  n, table.records.data_ptr(), table.bounds.data_ptr(), table.n_tiles, *args,
                  keep.data_ptr(), lists.data_ptr(), counts.data_ptr(), partial.data_ptr(),
                  max_blocks, out.data_ptr())
    return counts[n_rb:]


def sphere_sweep(ray_o, ray_d, hit_time, spheres, ext: float, med_color,
                 n_spheres: int, phase_const: float) -> torch.Tensor:
    """Accumulate the sphere-map volume estimate for every ray: (N, 3) f32.

    ``ray_o``/``ray_d``: (N, 3) f32; ``hit_time``: (N,) f32 (inf = miss);
    ``spheres``: a `SphereTable`, or on the CPU also a bare (FIELDS, P)
    table; ``ext``: the scalar extinction; ``med_color``: (3,) f32. CPU
    tensors take `sphere_sweep_plain`; CUDA tensors launch K-sweep on the
    `SphereTable` (a bare table raises)."""
    _check_args(ray_o, ray_d, hit_time, spheres, med_color)
    if ray_o.device.type == "cpu":
        table = spheres.spheres_t if isinstance(spheres, SphereTable) else spheres
        return sphere_sweep_plain(ray_o, ray_d, hit_time, table, ext, med_color,
                                  n_spheres, phase_const)
    _check_kernel_table(ray_o, spheres, n_spheres)
    out = torch.zeros((ray_o.shape[0], 3), dtype=torch.float32, device=ray_o.device)
    if out.shape[0] and spheres.n_spheres:
        med_color = med_color.contiguous()
        scale = float(phase_const) * 3.0 / math.pi
        _launch("sphere_sweep", "rpt_sphere_sweep", ray_o, ray_d, hit_time, spheres,
                (float(ext), scale, med_color.data_ptr()), out)
    return out


def pierced_count(ray_o, ray_d, hit_time, table: SphereTable):
    """Verification only (the main path never calls it): per ray the number
    of spheres it pierces, (N,), and per block of RAYS rays the number of
    tiles kept, (n_rb,). CUDA tensors run K-sweep's cull and pierce test
    (the second entry point of `csrc/sphere_sweep.cu`; int32 results); CPU
    tensors take `pierced_count_plain` and `tile_keep_plain` (int64)."""
    _check_args(ray_o, ray_d, hit_time, table)
    n = ray_o.shape[0]
    n_rb = -(-n // RAYS)
    if ray_o.device.type == "cpu":
        count = pierced_count_plain(ray_o, ray_d, hit_time, table.spheres_t, table.n_spheres)
        keep = tile_keep_plain(ray_o, ray_d, hit_time, table)
        keep = torch.cat([keep, keep.new_zeros((n_rb * RAYS - n, table.n_tiles))])
        return count, keep.reshape(n_rb, RAYS, table.n_tiles).any(dim=1).sum(dim=1)
    _check_kernel_table(ray_o, table, table.n_spheres)
    count = torch.zeros(n, dtype=torch.int32, device=ray_o.device)
    if n == 0 or table.n_spheres == 0:
        return count, torch.zeros(n_rb, dtype=torch.int32, device=ray_o.device)
    offsets = _launch("pierced_count", "rpt_sphere_pierced", ray_o, ray_d, hit_time, table, (),
                      count)
    return count, offsets[1:] - offsets[:-1]
