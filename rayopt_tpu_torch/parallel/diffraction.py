"""Differentiable diffraction metrics: Strehl ratio, PSF, MTF.

The counterpart of the JAX package's rayopt_tpu.parallel.diffraction.
The host path (GeometricTrace.psf) resamples the exit-pupil OPD with
scipy.griddata and FFTs in NumPy.  Here the whole pipeline is torch:
rays scatter their complex amplitude exp(-2 pi i W) onto a regular
pupil grid with bilinear (cloud-in-cell) weights -- a differentiable
scatter, its real and imaginary parts as two real index_add -- and
torch.fft produces the PSF/MTF on the rays' device.  The Strehl ratio
needs no grid: it is the squared magnitude of the weighted mean phasor
over the pupil, with the tilt (image-point choice) optionally removed
by a closed-form weighted least-squares fit.

The per-ray OPD comes from parallel.grad.opd_rays (engine="xla",
autograd through the plain trace) or, with engine="adjoint", from
ops.cuda_grad.adjoint_opd_rays (the OPD kernel K8 and its adjoint K9 on
a CUDA bundle).
"""

import math

import torch

from .grad import opd_rays


def _pupil_samples(table, y0, u0, w, **opd_kw):
    """(opd, xy, weights, good): NaN-guarded pupil samples, the weights
    normalized over the live samples."""
    biconic = opd_kw.pop("biconic", False)
    if opd_kw.pop("engine", "xla") == "adjoint":
        # the specialized engine reads each row's own branch
        from ..ops.cuda_grad import adjoint_opd_rays
        opd, xy = adjoint_opd_rays(table, y0, u0, with_pupil=True, **opd_kw)
    else:
        opd, xy = opd_rays(table, y0, u0, with_pupil=True, biconic=biconic,
                           **opd_kw)
    good = torch.isfinite(opd) & torch.isfinite(xy).all(1)
    if w is None:
        w = torch.ones_like(opd)
    wg = torch.where(good, torch.as_tensor(w).to(opd), 0.)
    wg = wg/wg.sum()
    opd = torch.where(good, opd, 0.)
    xy = torch.where(good[:, None], xy, 0.)
    return opd, xy, wg, good


def _remove_tilt(opd, xy, wg):
    """Subtract the weighted least-squares plane a + b x + c y (piston +
    tilt) from the wavefront -- closed form, differentiable; the 3x3
    solve reports no status to the host."""
    basis = torch.stack([torch.ones_like(opd), xy[:, 0], xy[:, 1]], 1)
    gram = basis.T @ (wg[:, None]*basis)
    rhs = basis.T @ (wg*opd)
    eye = torch.eye(3, dtype=opd.dtype, device=opd.device)
    coef = torch.linalg.solve_ex(gram + 1e-30*eye, rhs[:, None])[0][:, 0]
    return opd - basis @ coef


def _phasor(opd):
    """(cos, sin) of 2 pi W: exp(-2 pi i W) = cos - i sin."""
    arg = 2*math.pi*opd
    return torch.cos(arg), torch.sin(arg)


def strehl_ratio(table, y0, u0, w=None, remove_tilt=True, **opd_kw):
    """Differentiable Strehl ratio: |sum w exp(-2 pi i W)|^2 over the
    pupil (weights from the pupil quadrature), i.e. the on-axis PSF
    intensity relative to the diffraction limit.  `remove_tilt`
    re-centres on the best image point (piston cancels in the modulus
    automatically)."""
    opd, xy, wg, good = _pupil_samples(table, y0, u0, w, **opd_kw)
    return strehl_of_samples(opd, xy, wg, remove_tilt)


def strehl_of_samples(opd, xy, wg, remove_tilt=True):
    """The Strehl ratio of NaN-free pupil samples: OPD (waves), landing
    xy (N, 2) and weights summing to 1 over the live samples."""
    if remove_tilt:
        opd = _remove_tilt(opd, xy, wg)
    cos, sin = _phasor(opd)
    return torch.square((wg*cos).sum()) + torch.square((wg*sin).sum())


def strehl_marechal(table, y0, u0, w=None, **opd_kw):
    """Marechal approximation exp(-(2 pi sigma)^2) from the weighted
    wavefront variance -- cheaper and smoother than the exact phasor
    sum; accurate for Strehl >~ 0.3."""
    opd, xy, wg, good = _pupil_samples(table, y0, u0, w, **opd_kw)
    opd = _remove_tilt(opd, xy, wg)
    var = (wg*torch.square(opd)).sum()
    return torch.exp(-(2*math.pi)**2*var)


def pupil_grid(table, y0, u0, w=None, ngrid=64, half=None, **opd_kw):
    """Complex pupil function on an (ngrid, ngrid) grid.

    Rays deposit w * exp(-2 pi i W) with bilinear (cloud-in-cell)
    weights; the deposit is normalized by the deposited weight per
    cell, so nonuniform ray densities (hexapolar, quadrature bundles)
    do not imprint on the amplitude.  Returns (grid, cell_size).
    `half` fixes the grid half-width (for summing wavelengths on a
    common grid); default is the bundle's own footprint.  Fully
    differentiable (scatter-add only).  On a CUDA bundle index_add
    sums with atomics, so the order of each cell's sum (and its last
    bits) varies from run to run."""
    opd, xy, wg, good = _pupil_samples(table, y0, u0, w, **opd_kw)
    if half is None:
        half = torch.where(good[:, None], xy, 0.).abs().max().detach() \
            * 1.0001
    pos = (xy/half + 1.)*((ngrid - 1)/2.)   # [0, ngrid-1]
    base = torch.clamp(torch.floor(pos), 0, ngrid - 2).to(torch.long)
    frac = pos - base
    cos, sin = _phasor(opd)
    re = torch.where(good, cos, 0.)
    im = torch.where(good, -sin, 0.)
    size = ngrid*ngrid
    dep_re = dep_im = den = torch.zeros(size, dtype=opd.dtype,
                                        device=opd.device)
    for di in (0, 1):
        for dj in (0, 1):
            cell_w = (torch.abs(1 - di - frac[:, 0])
                      * torch.abs(1 - dj - frac[:, 1]))*wg
            cell = (base[:, 0] + di)*ngrid + base[:, 1] + dj
            dep_re = dep_re.index_add(0, cell, cell_w*re)
            dep_im = dep_im.index_add(0, cell, cell_w*im)
            den = den.index_add(0, cell, cell_w)
    lit = den > 1e-12*den.max()
    safe = torch.where(lit, den, 1.)
    grid = torch.complex(torch.where(lit, dep_re/safe, 0.),
                         torch.where(lit, dep_im/safe, 0.))
    return grid.reshape(ngrid, ngrid), 2*half/(ngrid - 1)


def psf_grid(table, y0, u0, w=None, ngrid=64, pad=2, wavelength=None,
             radius=None, scale=1e-3, half=None, **opd_kw):
    """Diffraction PSF: FFT of the gridded pupil function.

    Returns (p, q, psf): angular-ish frequency axes (cycles scaled by
    radius, matching GeometricTrace.psf) and the normalized
    intensity."""
    grid, dx = pupil_grid(table, y0, u0, w, ngrid, half=half,
                          wavelength=wavelength, radius=radius,
                          scale=scale, **opd_kw)
    n = pad*ngrid
    field = torch.fft.fft2(grid, s=(n, n))
    psf = torch.square(field.real) + torch.square(field.imag)
    psf = psf/psf.sum()
    cycles = scale/wavelength
    # fftfreq(n, d) = fftfreq(n, 1)/d, with d a tensor: no host sync
    step = dx*cycles/(radius if radius is not None else 1.)
    freq = torch.fft.fftfreq(n, dtype=psf.dtype, device=psf.device)/step
    p, q = torch.broadcast_tensors(freq[:, None], freq[None, :])
    return p, q, psf


def psf_polychromatic(table, bundles, ngrid=64, pad=2, radius=None,
                      scale=1e-3, spectral_weights=None, half=None,
                      **opd_kw):
    """Spectrally-weighted PSF: per-wavelength PSFs (each bundle is (y0,
    u0, w, chroma) from bundles_from_system, chroma carrying the table
    index overrides and a 'wavelength' key) summed on a common pupil
    grid.  Returns (p, q, psf) on the first bundle's axes."""
    if spectral_weights is None:
        spectral_weights = [1./len(bundles)]*len(bundles)
    if half is None:
        half = max(float(torch.as_tensor(b[0])[:, :2].abs().max())
                   for b in bundles)
    total = axes = None
    for sw, (y0, u0, w, chroma) in zip(spectral_weights, bundles):
        chroma = dict(chroma)
        l = chroma.pop("wavelength")
        tab = table.replace(**{k: v.to(table.curvature.device)
                               for k, v in chroma.items()})
        p, q, psf = psf_grid(tab, y0, u0, w, ngrid, pad, wavelength=l,
                             radius=radius, scale=scale, half=half,
                             **opd_kw)
        total = psf*sw if total is None else total + psf*sw
        if axes is None:
            axes = (p, q)
    return axes[0], axes[1], total/total.sum()


def mtf_radial(table, y0, u0, w=None, ngrid=64, pad=2, **kw):
    """Modulation transfer function |FFT(PSF)| along the two axes;
    returns (freq_index, mtf_x, mtf_y) normalized to MTF(0) = 1."""
    p, q, psf = psf_grid(table, y0, u0, w, ngrid, pad, **kw)
    mtf = torch.fft.fft2(psf).abs()
    mtf = mtf/mtf[0, 0]
    n = mtf.shape[0]//2
    return torch.arange(n, device=mtf.device), mtf[:n, 0], mtf[0, :n]
