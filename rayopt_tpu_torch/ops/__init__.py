from .tables import (  # noqa: F401
    SurfaceTable, make_table, table_from_numpy, lower_pose, rodrigues,
    is_anamorphic, stack_tables, table_at,
)
from .kernels import (  # noqa: F401
    SurfaceSpec, specialize, specs_from_tuple, with_pose,
    surface_step, surface_step_spec,
)
from .geometric import (  # noqa: F401
    trace_rays, trace_rays_final, trace_components_final,
    trace_rays_final_fast, trace_rays_final_multi,
)
from .cuda_trace import (  # noqa: F401
    trace_final, trace_merit, trace_final_reference,
    trace_merit_reference, spot_rms_from_moments, trace_multi,
    trace_multi_reference,
)
from .cuda_grad import (  # noqa: F401
    weighted_moments, merit_adjoint, weighted_moments_reference,
    merit_adjoint_reference, spot_moments, adjoint_spot_rms,
    weighted_moments_multi, merit_adjoint_multi,
    weighted_moments_multi_reference, merit_adjoint_multi_reference,
    spot_moments_multi, union_spot_rms_from_moments,
    polychromatic_spot_rms,
)
from .cuda_df32 import (  # noqa: F401
    trace_final_df32, trace_multi_df32, trace_merit_df32,
    trace_merit_multi_df32, pack_plan,
)
from . import df32  # noqa: F401
