"""Canonical optical prescriptions: the achromatic doublet, the OSLO
50mm f/4 Cooke triplet, the classic 100mm f/3 double Gauss (the
headline benchmark lens) and an f/2 parabolic mirror.  The YAML texts are the JAX package's
(rayopt_tpu.models.prescriptions), so both packages build the same
systems.
"""

from ..formats import system_from_yaml

DOUBLET_YAML = """
description: "achromatic doublet 100mm"
object:
  type: finite
  radius: 1.0
  pupil: {type: slope, slope: .001, distance: 100., update_distance: False}
elements:
- {material: vacuum}
- {material: 1.51872, distance: 99.9, curvature: 1.611356421}
- {material: 1.66238, distance: .1, curvature: -2.455396159}
- {material: vacuum, distance: 0.0661308, curvature: -0.786448792}
- {distance: 0.93402287}
"""

COOKE_YAML = """
description: 'oslo cooke triplet example 50mm f/4 20deg'
wavelengths: [587.56e-9, 656.27e-9, 486.13e-9]
object: {angle_deg: 20, pupil: {radius: 6.25, aim: True}}
image: {type: finite, pupil: {radius: 0, update_radius: True}}
elements:
- {material: air}
- {roc: 21.25, distance: 5.0, material: SCHOTT-SK|N-SK16, radius: 6.5}
- {roc: -158.65, distance: 2.0, material: air, radius: 6.5}
- {roc: -20.25, distance: 6.0, material: SCHOTT-F|N-F2, radius: 5.0}
- {roc: 19.6, distance: 1.0, material: air, radius: 5.0}
- {material: air, radius: 4.75}
- {roc: 141.25, distance: 6.0, material: SCHOTT-SK|N-SK16, radius: 6.5}
- {roc: -17.285, distance: 2.0, material: air, radius: 6.5}
- {distance: 42.95, radius: 0.364}
stop: 5
"""

# THE classic 6-element double Gauss: the published US2532751-type
# sample (the OpticStudio "Double Gauss 28 degree field" prescription,
# EFL 99.5 mm, f/3, 28 deg full field) -- an external literature
# anchor, pinned against the PUBLISHED first-order data in
# tests/test_published.py.  (Until round 5 the stop gaps were
# mis-assigned -- stop gap 0, 14.253/12.428 shifted one row -- giving
# EFL 92.37; the published gap assignment restores EFL 99.56.)
DOUBLE_GAUSS_YAML = """
description: 'double gauss 99.5mm f/3 28deg (US2532751-type sample)'
wavelengths: [587.56e-9, 656.27e-9, 486.13e-9]
object: {angle_deg: 14, pupil: {radius: 16.7, aim: True}}
image: {type: finite, pupil: {radius: 0, update_radius: True}}
elements:
- {material: air}
- {roc: 54.153, distance: 10.0, material: SCHOTT-SK|N-SK2, radius: 29.2}
- {roc: 152.522, distance: 8.747, material: air, radius: 28.1}
- {roc: 35.951, distance: 0.5, material: SCHOTT-SK|N-SK16, radius: 24.0}
- {distance: 14.0, material: SCHOTT-F|F5, radius: 21.3}
- {roc: 22.270, distance: 3.777, material: air, radius: 14.8}
- {distance: 14.253, material: air, radius: 11.3}
- {roc: -25.685, distance: 12.428, material: SCHOTT-F|F5, radius: 14.3}
- {distance: 3.777, material: SCHOTT-SK|N-SK16, radius: 20.8}
- {roc: -36.980, distance: 10.834, material: air, radius: 21.1}
- {roc: 196.417, distance: 0.5, material: SCHOTT-SK|N-SK16, radius: 20.0}
- {roc: -67.148, distance: 6.858, material: air, radius: 20.0}
- {distance: 57.315, radius: 24.0}
stop: 6
"""

PARABOLIC_YAML = """
description: 'f/2 parabolic mirror'
object:
  type: infinite
  angle_deg: 1
  pupil: {radius: 25, distance: 25}
stop: 1
elements:
- {material: vacuum}
- {material: mirror, distance: 100, roc: -200, conic: -1, radius: 25}
- {material: vacuum, distance: -100, radius: 1}
"""


def _build(yaml_text, update=True):
    s = system_from_yaml(yaml_text)
    if update:
        s.update()
    return s


def doublet(update=True):
    return _build(DOUBLET_YAML, update)


def cooke_triplet(update=True):
    return _build(COOKE_YAML, update)


def double_gauss(update=True):
    return _build(DOUBLE_GAUSS_YAML, update)


def parabolic_mirror(update=True):
    return _build(PARABOLIC_YAML, update)


PRESCRIPTIONS = {
    "doublet": doublet,
    "cooke": cooke_triplet,
    "double_gauss": double_gauss,
    "parabolic": parabolic_mirror,
}
