from .prescriptions import (  # noqa: F401
    doublet, cooke_triplet, double_gauss, parabolic_mirror, anamorphic_pair,
    spectrograph, hybrid_achromat,
    PRESCRIPTIONS,
)
