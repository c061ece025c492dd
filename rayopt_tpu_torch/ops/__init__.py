from .tables import (  # noqa: F401
    SurfaceTable, make_table, table_from_numpy, lower_pose, rodrigues,
    is_anamorphic,
)
from .kernels import (  # noqa: F401
    SurfaceSpec, specialize, specs_from_tuple, with_pose,
    surface_step, surface_step_spec,
)
from .geometric import (  # noqa: F401
    trace_rays, trace_rays_final, trace_components_final,
    trace_rays_final_fast,
)
from .cuda_trace import (  # noqa: F401
    trace_final, trace_merit, trace_final_reference,
    trace_merit_reference, spot_rms_from_moments,
)
from .cuda_grad import (  # noqa: F401
    weighted_moments, merit_adjoint, weighted_moments_reference,
    merit_adjoint_reference, spot_moments, adjoint_spot_rms,
)
