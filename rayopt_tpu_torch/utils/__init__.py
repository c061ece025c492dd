from .math import (  # noqa: F401
    sinarctan, tanarcsin, norm, normalize, normalize_z, sagittal_meridional,
    sfloat, sint,
)
from .distributions import (  # noqa: F401
    pupil_distribution, gl_roots, gr_roots, interval_to_circle,
)
from .geometry import (  # noqa: F401
    rotation_matrix, euler_matrix, euler_from_matrix,
)
