from .prescriptions import (  # noqa: F401
    doublet, cooke_triplet, double_gauss, parabolic_mirror, PRESCRIPTIONS,
)
