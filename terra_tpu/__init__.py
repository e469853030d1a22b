"""terra_tpu: a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference CPU renderer terra-render/Terra (see SURVEY.md): wavefront SoA
path tracing under jit, counter-based threefry RNG for replay-exact
gradients, masked-pass BSDF dispatch, flattened light tables, SAH BVH +
per-ray CUDA traversal for large scenes, and pixel/sample sharding over device meshes.

Public API (the analogue of include/Terra.h:203-245):

    from terra_tpu import (
        Scene, Geometry, MaterialTable, Camera, RenderOptions, Film,
        Integrator, Tonemap, BSDFType, commit, render, develop,
    )
"""

from .scene import (  # noqa: F401
    ATTR,
    Accelerator,
    BSDFType,
    Camera,
    Geometry,
    Integrator,
    Intersector,
    LightTable,
    MaterialTable,
    RenderOptions,
    SamplingMethod,
    Scene,
    TextureAtlas,
    Tonemap,
    commit,
)
from .film import Film, develop, tonemap  # noqa: F401
from .render import render, render_chunk, trace  # noqa: F401
from . import scenes  # noqa: F401

__version__ = "0.1.0"
