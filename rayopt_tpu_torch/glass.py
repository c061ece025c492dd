"""Glass optimization: continuous (nd, vd) relaxation and a
polychromatic differentiable merit.

The counterpart of the JAX package's rayopt_tpu.glass, the
achromatization workflow:

1. `glass_assignment(system)` maps each solid element glass onto the
   SurfaceTable rows whose refractive indices it determines.
2. `glass_tables(tables, nd, vd, assignment, wavelengths)`
   differentiably rewrites the stacked per-wavelength tables
   (System.tables) from free (nd, vd) parameters through the linear
   Abbe model (materials.AbbeMaterial), so torch autograd flows from a
   chromatic merit into the glass variables.
3. `polychromatic_spot_rms(tables, ...)` is that merit: ONE
   centroid-referenced RMS over the union of all wavelengths' spot
   samples, so axial and lateral colour are penalized together with
   the monochromatic blur.  engine="xla" is autograd through the plain
   torch trace; engine="adjoint" is the stacked-wavelength kernels K6
   (forward) and K7 (analytic adjoint) on a CUDA bundle
   (ops.cuda_grad.polychromatic_spot_rms).
4. `glass_box_encode`/`glass_box_decode` keep the relaxed glasses
   inside the populated region of the glass map.

Not ported yet: the catalog snap (`nearest_glasses`,
`substitute_glasses`), which needs the sqlite glass library
(ROADMAP Queue 1 item 2); both raise NotImplementedError.
"""

import numpy as np
import torch

from .materials import lambda_d, lambda_C, lambda_F


def abbe_index(nd, vd, wavelength, lambda_ref=lambda_d,
               lambda_long=lambda_C, lambda_short=lambda_F):
    """materials.AbbeMaterial.refractive_index as a plain expression
    (broadcasts over tensor or array nd/vd/wavelength)."""
    return (nd + (wavelength - lambda_ref)
            / (lambda_long - lambda_short)*(1 - nd)/vd)


def glass_assignment(system):
    """Host-side: map each solid (non-mirror) element material onto
    the table rows it determines.

    Returns (a_before, a_after, owners): int arrays (S,) holding the
    parameter slot of the medium before/after each surface (-1 =
    fixed, e.g. air), and `owners`, the element indices whose
    materials define the slots (slot g's initial values are
    system[owners[g]].material.nd/.vd).

    Mirror systems are rejected: the propagated-index sign flips make
    glass slots ambiguous, and mirror substitution is not a glass
    pick anyway.
    """
    a_before, a_after = [], []
    cur = -1
    owners = []
    slot = {}
    for j, e in enumerate(system):
        a_before.append(cur)
        mat = getattr(e, "material", None)
        if mat is not None:
            if getattr(mat, "mirror", False):
                raise NotImplementedError(
                    "glass_assignment does not cover mirror systems")
            if getattr(mat, "solid", False):
                if j not in slot:
                    slot[j] = len(owners)
                    owners.append(j)
                cur = slot[j]
            else:
                cur = -1
        a_after.append(cur)
    return (np.asarray(a_before, np.int32),
            np.asarray(a_after, np.int32), owners)


def initial_glass_params(system, owners):
    """(nd, vd) start values from the owning elements' materials."""
    nd = np.array([float(system[j].material.nd) for j in owners])
    vd = np.array([float(system[j].material.vd) for j in owners])
    return nd, vd


def _like(x, ref):
    """x as a tensor in ref's dtype and device (a tensor keeps its
    autograd graph)."""
    return torch.as_tensor(x).to(dtype=ref.dtype, device=ref.device)


def glass_tables(tables, nd, vd, assignment, wavelengths):
    """Differentiably rewrite stacked per-wavelength tables (leading
    wavelength axis, from System.tables) with indices from free
    (nd, vd) parameter vectors via the Abbe model.  Rows not owned by
    a parameter slot (air, object space) keep their table values.

    Plain torch over (nd, vd): put it inside a merit and the glass
    variables join curvatures/distances as free design parameters
    (rows that own no slot get exactly zero gradient)."""
    a_before, a_after, _ = assignment
    ref = tables.n_before
    lam = _like(np.asarray(wavelengths, np.float64), ref)[:, None]
    n_g = abbe_index(_like(nd, ref), _like(vd, ref), lam)   # (L, G)

    def rewrite(assign, field):
        a = torch.as_tensor(np.asarray(assign), dtype=torch.long,
                            device=ref.device)
        if not n_g.shape[1]:
            return field
        return torch.where(a >= 0, n_g[:, a.clamp(min=0)], field)
    nb = rewrite(a_before, tables.n_before)
    na = rewrite(a_after, tables.n_after)
    # bare rows (same medium both sides) divide to exactly 1. because
    # nb and na are the same float; refractive rows get the real ratio
    return tables.replace(n_before=nb, n_after=na, mu=nb/na)


def polychromatic_spot_rms(tables, y0, u0, w=None, specs=None,
                           unroll=True, clip=False, nan_safe=True,
                           biconic=False, engine="xla", tile=None,
                           interpret=False):
    """ONE centroid-referenced weighted RMS over the union of every
    wavelength's image-surface spot samples.

    Every wavelength traces the same (y0, u0) bundle at weight w/nlam
    (w defaults to 1/N).  engine="xla": autograd through the plain
    torch trace (ops.geometric.trace_rays_final_multi); with nan_safe,
    dead rays are donor-substituted with zero weight independently per
    wavelength before the differentiated trace, and the root is
    sqrt(r2 + 1e-30) about the union centroid.  engine="adjoint": the
    stacked-wavelength kernels (ops.cuda_grad.polychromatic_spot_rms:
    K6 forward, K7 backward on a CUDA bundle, their plain versions on
    a CPU one), root sqrt(max(var, 0) + 1e-30) of the moments.
    `unroll`, `tile` and `interpret` (JAX/TPU options) are accepted
    and ignored; biconic=True raises NotImplementedError."""
    if engine == "adjoint":
        from .ops.cuda_grad import polychromatic_spot_rms as adjoint_rms
        return adjoint_rms(tables, y0, u0, w, specs=specs, clip=clip)
    if engine != "xla":
        raise ValueError("engine must be 'xla' or 'adjoint', got %r"
                         % (engine,))
    from .ops.geometric import trace_rays_final_multi
    from .parallel.grad import _detached
    y0 = torch.as_tensor(y0)
    u0 = torch.as_tensor(u0)
    nlam = tables.curvature.shape[0]
    n = y0.shape[0]
    if w is None:
        w = torch.ones(n, dtype=y0.dtype, device=y0.device)/n
    else:
        w = torch.as_tensor(w).to(device=y0.device, dtype=y0.dtype)
    yb = y0.expand(nlam, *y0.shape)
    ub = u0.expand(nlam, *u0.shape)
    wb = (w/nlam).expand(nlam, n)
    if nan_safe:
        with torch.no_grad():
            yp, up, _ = trace_rays_final_multi(_detached(tables), yb, ub,
                                               clip=clip, specs=specs,
                                               biconic=biconic)
            alive = (torch.isfinite(yp[..., :2]).all(-1)
                     & torch.isfinite(up).all(-1))            # (L, N)
            i0 = torch.argmax(alive.to(torch.uint8), dim=1)   # donor a λ
        lam = torch.arange(nlam, device=y0.device)
        yb = torch.where(alive[..., None], yb, yb[lam, i0][:, None])
        ub = torch.where(alive[..., None], ub, ub[lam, i0][:, None])
        wb = torch.where(alive, wb, 0.)
    y, u, t = trace_rays_final_multi(tables, yb, ub, clip=clip, specs=specs,
                                     biconic=biconic)
    pt = y[..., :2]                                           # (L, N, 2)
    good = torch.isfinite(pt).all(-1)
    wg = torch.where(good, wb, 0.)
    pt = torch.where(good[..., None], pt, 0.)
    wsum = wg.sum()
    mean = (wg[..., None]*pt).sum((0, 1))/wsum
    r2 = (wg*torch.square(pt - mean).sum(-1)).sum()/wsum
    return torch.sqrt(r2 + 1e-30)


#: the populated region of the vendor glass maps: outside this box
#: the relaxed optimum cannot be snapped to a real melt, so bounded
#: optimization keeps the continuous solution honest (an unbounded
#: chromatic merit always runs to vd -> inf, "dispersionless glass")
GLASS_BOX = {"nd": (1.44, 2.05), "vd": (18., 85.)}


def glass_box_encode(nd, vd, box=None):
    """(nd, vd) -> unconstrained logits for bounded optimization
    (inverse of glass_box_decode; values are clipped 1% inside the
    box so catalog edge glasses stay representable).  NumPy in and
    out."""
    box = box or GLASS_BOX
    out = []
    for v, (lo, hi) in ((nd, box["nd"]), (vd, box["vd"])):
        t = np.clip((np.asarray(v, float) - lo)/(hi - lo), .01, .99)
        out.append(np.log(t/(1 - t)))
    return tuple(out)


def glass_box_decode(xi_nd, xi_vd, box=None):
    """Unconstrained logits -> (nd, vd) inside the glass-map box via
    a sigmoid: optimize the logits freely, the glasses stay
    physical.  Differentiable (torch.sigmoid)."""
    box = box or GLASS_BOX
    lo_n, hi_n = box["nd"]
    lo_v, hi_v = box["vd"]
    nd = lo_n + (hi_n - lo_n)*torch.sigmoid(torch.as_tensor(xi_nd))
    vd = lo_v + (hi_v - lo_v)*torch.sigmoid(torch.as_tensor(xi_vd))
    return nd, vd


def _catalog_not_ported(what):
    raise NotImplementedError(
        "%s needs the sqlite glass catalog (io/library.py), which is not "
        "ported to rayopt_tpu_torch yet (ROADMAP Queue 1 item 2)" % what)


def nearest_glasses(nd, vd, count=5, library=None, nd_scale=0.01,
                    vd_scale=1.5, catalog="glass"):
    """Catalog glasses nearest a relaxed (nd, vd) optimum: not ported
    yet (raises NotImplementedError, ROADMAP Queue 1 item 2)."""
    _catalog_not_ported("nearest_glasses")


def substitute_glasses(system, nd, vd, owners, library=None,
                       catalog="glass"):
    """Write the nearest catalog glasses back into a System: not ported
    yet (raises NotImplementedError, ROADMAP Queue 1 item 2)."""
    _catalog_not_ported("substitute_glasses")
