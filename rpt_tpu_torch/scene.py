"""Scene description and compilation to flat device tables — port of
`rpt_tpu/scene.py` (`rpt/src/scene.rs`, `src/object.rs`).

``Scene.add`` accepts objects, lights, media, environments, and the
(geometry, material) dual add that registers emissive geometry as both a
visible object and a light (scene.rs:57-75). ``compile_scene`` lowers the
object list into structure-of-arrays torch tables on an explicit device:
mesh triangles are baked to world space and packed into one pair-packed
BVH; analytic primitives keep inverse and normal transforms.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .accel.bvh import build_bvh, pack_bvh
from .dtypes import DTYPE, resolve_device
from .environment import ColorEnvironment, Hdri
from .intersect import BVHTables, PlaneSet, PrimSet
from .lights import (
    AmbientLight,
    DirectionalLight,
    Light,
    ObjectLight,
    PointLight,
    compile_light,
)
from .materials import Material, MaterialTable
from .medium import Medium
from .ops.prim_hit import PrimRows, pack_prims
from .shapes import (
    Cube,
    Mesh,
    MonomialSurface,
    Plane,
    ShapeGroup,
    Sphere,
    transform_mesh,
    unwrap,
)
from .vec import Affine, Mat3, Vec3


class Object:
    """Shape + material (object.rs:10-32)."""

    def __init__(self, shape, material: Material | None = None):
        self.shape = shape
        self._material = material or Material()

    def material(self, material: Material) -> "Object":
        return Object(self.shape, material)


_LIGHT_TYPES = (PointLight, AmbientLight, DirectionalLight, ObjectLight)


class Scene:
    """Mutable scene builder (scene.rs:12-31)."""

    def __init__(self):
        self.objects: list[Object] = []
        self.lights: list = []
        self.media: list[Medium] = []
        self.environment = ColorEnvironment()

    def add(self, node):
        """SceneAdd overloads (scene.rs:39-81), including the object+light
        dual add for (geometry, material) tuples (scene.rs:57-75)."""
        if isinstance(node, Object):
            self.objects.append(node)
        elif isinstance(node, _LIGHT_TYPES):
            self.lights.append(node)
        elif isinstance(node, Medium):
            self.media.append(node)
        elif isinstance(node, (ColorEnvironment, Hdri)):
            self.environment = node
        elif isinstance(node, tuple) and len(node) == 2 and isinstance(node[1], Material):
            geometry, material = node
            self.objects.append(Object(geometry, material))
            self.lights.append(Light.Object(Object(geometry, material)))
        else:
            raise TypeError(f"Cannot add {type(node).__name__} to scene")

    def compile(self, device="cuda") -> "CompiledScene":
        return compile_scene(self, device)


@dataclass(frozen=True)
class CompiledScene:
    """Static structure of a compiled scene plus its ``tables`` of tensors
    on ``device``."""

    n_spheres: int
    n_planes: int
    n_cubes: int
    n_monomials: int
    n_tris: int
    lights: tuple  # tuple[CompiledLight, ...]
    media: tuple  # tuple[Medium, ...]
    environment: object
    t_min: float  # scale-aware ray epsilon (reference: 1e-12 in f64)
    shadow_eps: float  # relative back-off of the shadow-visibility test
    scale: float  # scene diameter estimate
    # "occlusion": no occluder strictly closer than the light (default);
    # "exact": the reference's literal NEE test (renderer.rs:395-396), the
    # closest hit must lie at the light distance (`rpt_tpu/scene.py:121`)
    nee_mode: str = "occlusion"
    device: torch.device = torch.device("cpu")
    tables: dict = field(compare=False, repr=False, default=None)
    # host seconds of the mesh's SAH build ("sah") and table packing ("pack")
    build_seconds: dict = field(compare=False, repr=False, default_factory=dict)
    # the analytic prims packed for K-prim (`ops.prim_hit.pack_prims`)
    prim_rows: PrimRows = field(compare=False, repr=False, default=None)

    def env_color(self, tables, direction) -> Vec3:
        return self.environment.get_color(tables["env"], direction)


def _prim_set(entries, device) -> PrimSet:
    mats = np.array([e[1] for e in entries], np.int32)
    m4 = np.stack([e[0] for e in entries])
    inv = np.linalg.inv(m4)
    lin = m4[:, :3, :3]
    params = np.array([e[2] for e in entries], np.float64)
    return PrimSet(
        world_to_obj=Affine.from_numpy(inv, device),
        normal_mat=Mat3.from_numpy(np.linalg.inv(lin).transpose(0, 2, 1), device),
        obj_to_world=Affine.from_numpy(m4, device),
        det=torch.tensor(np.linalg.det(lin), dtype=DTYPE, device=device),
        material=torch.tensor(mats, device=device),
        param=torch.tensor(params, dtype=DTYPE, device=device),
    )


def compile_scene(scene: Scene, device="cuda") -> CompiledScene:
    """Lower ``scene`` to tables on ``device`` (`rpt_tpu/scene.py:144-311`,
    without the cluster tables of the TPU tile path): the card unless the
    caller asks for ``"cpu"``. A CUDA device with no usable card raises."""
    device = resolve_device(device)
    materials: list[Material] = []
    mat_ids: dict[Material, int] = {}

    def mat_id(m: Material) -> int:
        if m not in mat_ids:
            mat_ids[m] = len(materials)
            materials.append(m)
        return mat_ids[m]

    spheres, cubes, monomials, planes = [], [], [], []
    tri_v, tri_n, tri_m = [], [], []
    points_min, points_max = [], []

    flat_objects = []
    for obj in scene.objects:
        base, matrix = unwrap(obj.shape)
        if isinstance(base, ShapeGroup):
            for member in base.shapes:
                mbase, mmatrix = unwrap(member)
                flat_objects.append((mbase, matrix @ mmatrix, obj._material))
        else:
            flat_objects.append((base, matrix, obj._material))

    for base, matrix, material in flat_objects:
        mid = mat_id(material)
        is_transformed = not np.allclose(matrix, np.eye(4))
        if isinstance(base, Sphere):
            spheres.append((matrix, mid, 0.0))
            _track_bbox(points_min, points_max, base.bounding_box(), matrix)
        elif isinstance(base, Cube):
            cubes.append((matrix, mid, 0.0))
            _track_bbox(points_min, points_max, base.bounding_box(), matrix)
        elif isinstance(base, MonomialSurface):
            if abs(base.exp - 4.0) > 1e-9:
                raise NotImplementedError("MonomialSurface requires exp == 4 (as the reference)")
            monomials.append((matrix, mid, base.height))
            _track_bbox(points_min, points_max, base.bounding_box(), matrix)
        elif isinstance(base, Plane):
            # {p . n = v} under x -> Mx + t maps to n' = M^-T n, v' = v + n'.t
            m4 = np.asarray(matrix, np.float64)
            n_new = np.linalg.inv(m4[:3, :3]).T @ np.asarray(base.normal, np.float64)
            v_new = float(base.value + n_new @ m4[:3, 3])
            planes.append((n_new, v_new, mid))
        elif isinstance(base, Mesh):
            mesh = transform_mesh(base, matrix) if is_transformed else base
            tri_v.append(mesh.vertices)
            tri_n.append(mesh.normals)
            tri_m.append(np.full(len(mesh), mid, np.int32))
            if len(mesh):
                points_min.append(mesh.vertices.reshape(-1, 3).min(0))
                points_max.append(mesh.vertices.reshape(-1, 3).max(0))
        else:
            raise NotImplementedError(f"Unsupported shape {type(base).__name__}")

    tables: dict = {}
    if spheres:
        tables["spheres"] = _prim_set(spheres, device)
    if cubes:
        tables["cubes"] = _prim_set(cubes, device)
    if monomials:
        tables["monomials"] = _prim_set(monomials, device)
    if planes:
        tables["planes"] = PlaneSet(
            normal=Vec3.from_array(np.stack([p[0] for p in planes]), device),
            value=torch.tensor(np.array([p[1] for p in planes]), dtype=DTYPE, device=device),
            material=torch.tensor(np.array([p[2] for p in planes], np.int32), device=device),
        )

    n_tris = 0
    build_seconds = {}
    if tri_v:
        v = np.concatenate(tri_v)
        n = np.concatenate(tri_n)
        m = np.concatenate(tri_m)
        n_tris = len(v)
        t0 = time.perf_counter()
        bvh = build_bvh(v.min(1), v.max(1))
        t1 = time.perf_counter()
        nodes, leaves, shade, stack_depth = pack_bvh(bvh, v, n, m)
        build_seconds = {"sah": t1 - t0, "pack": time.perf_counter() - t1}
        tables["bvh"] = BVHTables(
            nodes=torch.from_numpy(nodes).to(device),
            leaves=torch.from_numpy(leaves).to(device),
            shade=torch.from_numpy(shade).to(device),
            stack_depth=stack_depth,
        )

    compiled_lights = []
    light_tabs = []
    for light in scene.lights:
        st, tb = compile_light(light, device)
        compiled_lights.append(st)
        light_tabs.append(tb)
    tables["lights"] = tuple(light_tabs)
    tables["materials"] = MaterialTable.build(materials, device)
    tables["env"] = scene.environment.tables(device)

    # scale-aware epsilons: the reference's EPSILON=1e-12 (renderer.rs:17)
    # relies on f64; in f32 they scale with the scene diameter
    if points_min:
        lo = np.minimum.reduce(points_min)
        hi = np.maximum.reduce(points_max)
        scale = float(np.linalg.norm(hi - lo))
    else:
        scale = 1.0
    scale = max(scale, 1e-6)

    return CompiledScene(
        n_spheres=len(spheres),
        n_planes=len(planes),
        n_cubes=len(cubes),
        n_monomials=len(monomials),
        n_tris=n_tris,
        lights=tuple(compiled_lights),
        media=tuple(scene.media),
        environment=scene.environment,
        t_min=2e-4 * scale,
        shadow_eps=1e-3,
        scale=scale,
        nee_mode=getattr(scene, "nee_mode", "occlusion"),
        device=device,
        tables=tables,
        build_seconds=build_seconds,
        prim_rows=pack_prims(tables, device),
    )


def _track_bbox(points_min, points_max, bbox, matrix):
    """Transform the 8 bbox corners (shape.rs:154-177) for scene-scale
    estimation."""
    lo, hi = bbox
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
    )
    m4 = np.asarray(matrix, np.float64)
    world = corners @ m4[:3, :3].T + m4[:3, 3]
    points_min.append(world.min(0))
    points_max.append(world.max(0))
