"""The port's specialized intercept picks the cancellation-free root
form (kernels.intercept_spec): f/(g - d) where d and g differ in sign
or e == 0, else -(d + g)/e, one division.  The JAX package's
specialized intercept keeps -(d + g)/e, which cancels near a
paraboloid's axis and on a spherical row whose curvature tends to 0;
its generic intercept (intercept_conic) selects as the port does.  So
on two systems that hit the cancellation -- the f/2 parabolic mirror
and the double Gauss with its flat rows at c = 1e-12 -- the port's
specialized plain versions are held against the JAX package's GENERIC
engine, and the hand-written reverse (_step_vjp_reference, the model
of csrc/step_vjp.cuh) against autograd of the repaired step on rows
that take each form.  float64 and float32 on the CPU."""

import functools

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax.numpy as jnp
import rayopt_tpu as J
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT

F64_REL = 1e-12   # float64 spot RMS, port specialized vs JAX generic
F32_REL = 1e-4    # float32 spot RMS, of the JAX float64 generic one
OPD_ATOL = 1e-9   # waves: K8's plain OPD vs JAX opd_rays on the mirror
NRAYS = 2000      # aimed rays a field


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


def _near_flat(s, c=1e-12):
    """The system's table with every flat traced row at curvature c."""
    jt = s.table()
    cur = np.asarray(jt.curvature).copy()
    flat = cur == 0
    flat[0] = False
    cur[flat] = c
    return jt.replace(curvature=jnp.asarray(cur))


CASES = {"paraboloid": (.5, 1.), "near-flat double Gauss": (0., .7, 1.)}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX system, JAX table, port table, port specs, {field: (y0,
    u0)}) with NRAYS aimed rays a field, uniform over the pupil."""
    if name == "paraboloid":
        s = jmodels.parabolic_mirror()
        jt = s.table()
    else:
        s = jmodels.double_gauss()
        jt = _near_flat(s)
    tt = TT.table_from_numpy(jt)
    specs = TK.specialize(tt)
    rng = np.random.RandomState(3)
    rays = {}
    for field in CASES[name]:
        z, p = s.pupil((0., field))
        r = np.sqrt(rng.uniform(0, 1, NRAYS))
        th = rng.uniform(0, 2*np.pi, NRAYS)
        yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
        rays[field] = s.aim((0., field), yp, z, p, filter=False)
    return s, jt, tt, specs, rays


def _spot_rms(y):
    y = np.asarray(y, dtype=np.float64)
    good = np.isfinite(y[:, 0]) & np.isfinite(y[:, 1])
    pts = y[good, :2]
    return np.sqrt(((pts - pts.mean(0))**2).sum(1).mean()), good


def test_cases_hit_the_cancelling_rows():
    """The paraboloid's conic row and the near-flat spherical rows are
    specialized as curved rows (the branch that cancelled)."""
    _, _, tt, specs, _ = _case("paraboloid")
    assert not specs[1].flat and not specs[1].spherical
    assert float(tt.conic[1]) == -1
    _, _, tt, specs, _ = _case("near-flat double Gauss")
    near = [j for j in range(1, len(specs)) if float(tt.curvature[j]) == 1e-12]
    assert len(near) == 4
    assert all(specs[j].spherical and not specs[j].flat for j in near)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_specialized_trace_matches_jax_generic(name, dtype):
    """trace_final_reference (the plain version of K1) and the K2/K4
    plain moments against the JAX package's generic trace_rays_final."""
    _, jt, tt, specs, rays = _case(name)
    for field, (y0, u0) in rays.items():
        yj, uj, _ = JG.trace_rays_final(jt, jnp.asarray(y0), jnp.asarray(u0))
        want, good = _spot_rms(yj)
        assert good.sum() > NRAYS//2
        state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dtype)
                      for c in (*y0.T, *u0.T))
        out, _ = CT.trace_final_reference(tt, specs, state)
        got, gmask = _spot_rms(torch.stack(out[:2], 1).numpy())
        rel = abs(got - want)/want
        if dtype == torch.float64:
            nptest.assert_array_equal(gmask, good)
            assert rel <= F64_REL, (field, rel)
            # the plain K2 and K4 moments see the same positions
            mom = CT.trace_merit_reference(tt, specs, state)
            assert float(mom[0]) == good.sum()
            w = torch.full((NRAYS,), 1./NRAYS, dtype=dtype)
            wm = CG.weighted_moments_reference(tt, specs, state, w)
            nptest.assert_allclose(float(wm[1])/float(wm[0]),
                                   np.asarray(yj)[good, 0].mean(),
                                   rtol=0, atol=1e-12)
        else:
            assert rel <= F32_REL, (field, rel)


def test_opd_plain_matches_jax_on_the_mirror():
    """K8's plain version (adjoint_opd_rays on a CPU bundle) against the
    JAX package's opd_rays (generic engine) on the mirror, half field,
    ray 0 the chief ray."""
    s = jmodels.parabolic_mirror()
    g = J.GeometricTrace(s)
    g.rays_point((0, .5), nrays=400, distribution="hexapolar", filter=False)
    jt = s.table(g.l)
    kw = dict(ref=g.ref, radius=-s.image.pupil.distance, wavelength=g.l,
              scale=s.scale, finite=s.object.finite)
    y0, u0 = g.y[0], g.u[0]
    want = np.asarray(JGR.opd_rays(jt, jnp.asarray(y0), jnp.asarray(u0),
                                   **kw))
    tt = TT.table_from_numpy(jt)
    got = CG.adjoint_opd_rays(tt, torch.from_numpy(y0), torch.from_numpy(u0),
                              specs=TK.specialize(tt), **kw).detach().numpy()
    good = np.isfinite(want)
    assert good.sum() > 100
    nptest.assert_array_equal(np.isfinite(got), good)
    nptest.assert_allclose(got[good], want[good], rtol=0, atol=OPD_ATOL)


def _row(curvature, conic=0., alternate=0., mu=1/1.5):
    return dict(curvature=[0., curvature], conic=[0., conic], mu=[1., mu],
                radius=[np.inf, np.inf], alternate=[0., alternate],
                n_before=[1., 1.], n_after=[1., 1./mu],
                offset=[[0., 0., 0.], [0., 0., 5.]])


ROWS = {
    "spherical": _row(1/40.),
    "spherical_alternate": _row(1/12., alternate=1.),
    "near_flat": _row(1e-12),
    "conic": _row(1/35., conic=-.7),
    "conic_alternate": _row(1/20., conic=-.5, alternate=1.),
    "paraboloid_mirror": _row(-1/100., conic=-1., mu=-1.),
}


def _conj(state, surf, spec):
    """Which rays take the conjugate form f/(g - d) at this row."""
    x, y, z, ux, uy, uz = state
    z = z - surf.offset[2]
    c, k1 = surf.curvature, 1 + surf.conic
    if spec.spherical:
        uyd, uu, yy = ux*x + uy*y + uz*z, 1., x*x + y*y + z*z
    else:
        uyd = ux*x + uy*y + k1*uz*z
        uu = ux*ux + uy*uy + k1*uz*uz
        yy = x*x + y*y + k1*z*z
    d, e, f = c*uyd - uz, c*uu, c*yy - 2*z
    g = TK._sqrt0(d*d - e*f)*(-1. if spec.alternate else 1.)
    return (d*g <= 0) | (e == 0)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_step_vjp_takes_the_derivative_of_either_form(name):
    """_step_vjp_reference against autograd of the repaired
    surface_step_spec, ray by ray (per-ray parameter copies), on rows
    whose rays take the conjugate form (normal rays, d*g < 0; the
    paraboloid's axial rays, e == 0) or the direct one (an alternate
    root, d*g > 0)."""
    tt = TT.make_table(**ROWS[name])
    spec = TK.specialize(tt)[1]
    rng = np.random.RandomState(5)
    n = 200
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-6, 6, (n, 2))
    y[:, 2] = -1.
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-.15, .15, (n, 2))
    u[:20, :2] = 0.                       # axial rays: e == 0 on a paraboloid
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    state = [torch.from_numpy(np.ascontiguousarray(c)).requires_grad_()
             for c in (*y.T, *u.T)]
    row = tt.row(1)
    conj = _conj(tuple(s.detach() for s in state), row, spec)
    want_conj = not spec.alternate
    assert bool((conj == want_conj).sum() > n//2)
    if name == "paraboloid_mirror":
        assert bool(conj[:20].all())
    per_ray = {f: getattr(row, f).expand(n).clone().requires_grad_()
               for f in ("curvature", "conic", "mu")}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    surf = row._replace(offset=offset, **per_ray)
    out, _ = TK.surface_step_spec(tuple(state), surf, spec, False)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert live.sum() > n//2
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"]]
    want = torch.autograd.grad(
        sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g)),
        leaves, allow_unused=True)
    want = [torch.zeros_like(v) if w is None else w
            for v, w in zip(leaves, want)]
    got_state, got_p = CG._step_vjp_reference(
        tuple(s.detach() for s in state), row, spec, g)
    pairs = list(zip(got_state, want[:6])) + [
        (got_p[0], want[6]), (got_p[1], want[7]), (got_p[2], want[8][0]),
        (got_p[3], want[8][1]), (got_p[4], want[8][2]), (got_p[5], want[9])]
    for i, (a, b) in enumerate(pairs):
        a = torch.broadcast_to(a, b.shape)[live].numpy()
        b = b[live].numpy()
        nptest.assert_allclose(a, b, rtol=1e-9,
                               atol=1e-12*max(np.abs(b).max(), 1.),
                               err_msg="slot %d" % i)
