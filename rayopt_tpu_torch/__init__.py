"""rayopt_tpu_torch -- the optical design and ray-tracing framework of
rayopt_tpu, ported to PyTorch and CUDA.

The JAX package rayopt_tpu is the reference; this package keeps its
module names, so each part has an obvious counterpart.  It imports
torch, numpy, scipy and yaml, never jax.

Ported so far: the front end (materials from the built-in glass
table, elements, pupils, conjugates, System with its paraxial solve
and host pupil aiming, YAML round trip, the model prescriptions), the
SurfaceTable lowering, the torch trace engines (flat, spherical and
conic rows), and the fused trace (K1) and spot-moment merit (K2)
kernels, hand-written in CUDA C++ for Hopper (ops.cuda_trace).

Tables and traces default to float64 on the CPU; move a bundle to a
CUDA device to run the kernels.
"""

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
    Element, Interface, Spheroid, TransformMixin,
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

__version__ = "0.1.0"
