"""Scalar grating efficiency (blaze) models.

The trace engines answer *where* each diffraction order goes
(kernels.refract_grating, the generalized Spencer & Murty
construction); this module answers *how much light* each order
carries, with the classic scalar-theory blaze model: a sawtooth
(blazed) groove profile acts as an array of facet mirrors, and the
power of order m follows

    eta_m(lambda) = sinc^2(m - m_b(lambda)),
    m_b = (2 d / lambda) sin(theta_B) cos(alpha - theta_B)

where d is the groove spacing, theta_B the blaze angle, and alpha the
incidence angle from the grating normal (m_b is the "blaze order" --
the order into which the facet specular direction falls).  sinc is the
normalized numpy convention sin(pi x)/(pi x), so the identity
sum_m sinc^2(m - x) = 1 makes the model exactly energy-conserving
over all integer orders.  Validity: scalar regime (d >> lambda),
unpolarized; it reproduces the textbook behaviors -- peak efficiency 1
at the blaze wavelength lambda_B = 2 d sin(theta_B) cos(alpha -
theta_B)/m, zero-order suppression at blaze, and the 40% bandwidth
shoulders of a first-order blazed grating.

The reference (quartiq/rayopt) has no gratings at all; the Zemax
analog is the diffraction-efficiency data of a DGRATING surface.  This
module is the JAX package's rayopt_tpu.gratings (plain numpy), kept as
its own copy.
"""

import numpy as np

__all__ = ["blaze_order", "blaze_efficiency", "order_weights"]


def blaze_order(wavelength, frequency, blaze_deg, incidence_deg=0.,
                scale=1e-3):
    """The (real-valued) blaze order m_b(lambda): the diffraction
    order into which a blazed facet's specular reflection falls.

    wavelength in meters; frequency in lines per system length unit
    (e.g. 600. on a mm-scaled system); scale is the system unit in
    meters (System.scale)."""
    d = 1./np.abs(frequency)
    lam = np.asarray(wavelength, float)/scale
    tb = np.deg2rad(blaze_deg)
    a = np.deg2rad(incidence_deg)
    return 2.*d/lam*np.sin(tb)*np.cos(a - tb)


def blaze_efficiency(order, wavelength, frequency, blaze_deg,
                     incidence_deg=0., scale=1e-3):
    """Scalar blaze efficiency eta_m(lambda) in [0, 1].  Broadcasts
    over `order` and `wavelength`."""
    mb = blaze_order(wavelength, frequency, blaze_deg, incidence_deg,
                     scale)
    return np.sinc(np.asarray(order, float) - mb)**2


def order_weights(grating, wavelengths, orders, incidence_deg=0.,
                  scale=1e-3, model="scalar", **rcwa_kw):
    """(len(orders), len(wavelengths)) efficiency table of a Grating
    element.  An unblazed grating (blaze_deg is None) weights all
    requested orders equally (1/len(orders)).

    model="scalar" (default) uses the sinc^2 blaze model above;
    model="rcwa" (the JAX package's rigorous coupled-wave model) is not
    ported and raises NotImplementedError."""
    wavelengths = np.atleast_1d(np.asarray(wavelengths, float))
    orders = np.atleast_1d(np.asarray(orders))
    blaze = getattr(grating, "blaze_deg", None)
    if blaze is None:
        return np.full((orders.size, wavelengths.size),
                       1./orders.size)
    if model == "rcwa":
        raise NotImplementedError(
            "the RCWA grating model is not ported to rayopt_tpu_torch yet "
            "(ROADMAP Queue 1 item 13)")
    if model != "scalar":
        raise ValueError("model must be 'scalar' or 'rcwa'")
    return blaze_efficiency(orders[:, None], wavelengths[None, :],
                            grating.grating_frequency, blaze,
                            incidence_deg, scale)
