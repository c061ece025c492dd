"""Differentiable merits and gradient-based lens optimization
(counterpart of rayopt_tpu.parallel; sharding, tolerancing and the
population optimizers are not ported yet)."""

from .grad import (  # noqa: F401
    spot_rms, trace_rms_merit, write_back_table, paraxial_seed,
    first_order_penalty, composite_merit, bundles_from_system,
    bundles_from_numpy, bundles_to, optimize_system, optimize_grad,
    opd_rays, wavefront_rms, freeform_scales,
)
from .diffraction import (  # noqa: F401
    strehl_ratio, strehl_marechal, pupil_grid, psf_grid, psf_polychromatic,
    mtf_radial,
)
