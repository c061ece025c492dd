"""rayopt_tpu_torch -- the optical design and ray-tracing framework of
rayopt_tpu, ported to PyTorch and CUDA.

The JAX package rayopt_tpu is the reference; this package keeps its
module names, so each part has an obvious counterpart.  It imports
torch, numpy, scipy and yaml, never jax.

Ported so far: the front end (materials from the built-in glass
table, elements, pupils, conjugates, System with its paraxial solve
and pupil aiming, per field on the host and for every field at once
on the table's device (System.pupils, ops.aiming), YAML round trip,
the model prescriptions), the
SurfaceTable lowering, the torch trace engines (flat, spherical and
conic rows), and the fused trace (K1) and spot-moment merit (K2)
kernels, hand-written in CUDA C++ for Hopper (ops.cuda_trace); the
differentiable paraxial engine (ops.paraxial), the differentiable
spot-RMS merit with its weighted-moment (K4) and analytic-adjoint (K5)
kernels (ops.cuda_grad), and the lens optimizer (parallel.grad:
spot_rms, bundles_from_system, optimize_grad with engines "xla" and
"adjoint", optimize_system); the polychromatic slice: stacked
per-wavelength and per-configuration tables (System.tables,
System.config_tables), the batched trace (ops.geometric.
trace_rays_final_multi), the stacked-wavelength trace (K3,
ops.cuda_trace.trace_multi), weighted moments (K6) and analytic
adjoint (K7, ops.cuda_grad.polychromatic_spot_rms), and the glass
relaxation (glass: glass_assignment, glass_tables,
polychromatic_spot_rms, the glass box).

Tables and bundles default to float64 on the CUDA card
(`default_device()`), whatever the machine has; a machine without one
asks for the CPU with `set_default_device("cpu")` (or `device="cpu"`),
where every kernel wrapper runs its plain PyTorch version.
"""

from .device import default_device, set_default_device  # noqa: F401

from .utils.math import (  # noqa: F401
    sinarctan, tanarcsin, norm, normalize, normalize_z,
    sagittal_meridional, sfloat, sint,
)
from .utils.distributions import (  # noqa: F401
    pupil_distribution, gl_roots, gr_roots, interval_to_circle,
)
from .utils.cachend import (  # noqa: F401
    CacheND, NearestCacheND, LinearCacheND, PolarCacheND,
)
from .utils.registry import NameMixin  # noqa: F401
from .materials import (  # noqa: F401
    Material, ModelMaterial, AbbeMaterial, CoefficientsMaterial,
    vacuum, mirror, air, fraunhofer, Thermal, GLASSES,
)
from .elements import (  # noqa: F401
    Biconic, DiffractiveSurface, Element, FreeformXY, Grating, Interface,
    Spheroid, Toroid, TransformMixin, ZernikeSag,
)
from .pupils import Pupil, RadiusPupil, NaPupil, SlopePupil, FnoPupil  # noqa: F401
from .conjugates import Conjugate, FiniteConjugate, InfiniteConjugate  # noqa: F401
from .system import System  # noqa: F401
from .trace.base import Trace  # noqa: F401
from .trace.paraxial import ParaxialTrace  # noqa: F401
from .trace.geometric import GeometricTrace, FullTrace  # noqa: F401
from .formats import (  # noqa: F401
    system_from_yaml, system_to_yaml, system_from_json, system_to_json,
    system_from_array, system_from_text,
)

from . import glass  # noqa: F401,E402

__version__ = "0.1.0"
