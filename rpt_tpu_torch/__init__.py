"""rpt_tpu_torch — the PyTorch/CUDA port of rpt_tpu for NVIDIA Hopper.

A second package beside the JAX reference `rpt_tpu`: the same scene API
(Scene/Object/Material/Medium/Camera/Renderer), torch tensors on an
explicit device, and hand-written CUDA kernels for the hot loops
(`rpt_tpu_torch/csrc`). It imports neither jax nor rpt_tpu.

Every integrator of the reference runs: path tracing with and without
media (``Renderer.render``, ``sample``, ``iterative_render``; meshes of
any size through the BVH kernels K1/K2) and the three photon kinds
(``photon_map_render``, ``photon_point_query_beam_render``,
``photon_beam_query_beam_render``; K-knn and K-sweep). Scenes may be lit
by an ``Hdri`` sky, meshes loaded with the OBJ/MTL/STL loaders of
``io`` (``load_hdr`` decodes Radiance RGBE itself), and particles moved by
the RK4 systems of ``ode``. ``Renderer.profile`` records a sample under
``torch.profiler``, and ``RPT_TPU_PREVIEW`` cuts a render for smoke runs.
The flat exports are `rpt_tpu/__init__.py`'s; the sharded renders over
``torch.distributed`` are ``rpt_tpu_torch.parallel``'s, as in the JAX
package not exported flat.
"""

from .buffer import Buffer, Filter  # noqa: F401
from .camera import Camera  # noqa: F401
from .color import color_bytes, hex_color  # noqa: F401
from .environment import ColorEnvironment, Environment, Hdri  # noqa: F401
from .io import load_hdr, load_mtl, load_obj, load_obj_with_mtl, load_stl  # noqa: F401
from .lights import (  # noqa: F401
    AmbientLight,
    DirectionalLight,
    Light,
    ObjectLight,
    PointLight,
)
from .materials import Material  # noqa: F401
from .medium import Medium  # noqa: F401
from .ode import (  # noqa: F401
    MarblesSystem,
    ParticleState,
    ParticleSystem,
    SimpleCircleSystem,
    SolidGravitySystem,
)
from .renderer import Renderer  # noqa: F401
from .scene import CompiledScene, Object, Scene, compile_scene  # noqa: F401
from .shapes import (  # noqa: F401
    Cube,
    KdTree,
    Mesh,
    MonomialSurface,
    Plane,
    ShapeGroup,
    Sphere,
    Transformed,
    cube,
    monomial_surface,
    plane,
    polygon,
    sphere,
)
from .vec import Vec3  # noqa: F401

__version__ = "0.1.0"
