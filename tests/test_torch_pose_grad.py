"""Pose gradients through the port's analytic adjoints K5, K7 and K9 (the
rot cotangent) against the JAX package, in float64 on the CPU.

A rot that requires grad (a tilt lowered by tables.lower_pose) makes an
adjoint's key a rot key: nine slots more a row, each rotated row's
rotation R[i][j], last.  Held here: the torch models of the device
reverses (cuda_grad._step_vjp_reference with `out`, the sphere tail's
_opd_tail_vjp_reference with `state`) against autograd of
kernels.surface_step_spec on a rotated row of every kind; the K5, K7
and K9 models against their autograd plain versions; adjoint_spot_rms
and adjoint_wavefront_rms d/d(tilt, decenter) against the JAX package's
XLA twins (which its own tests pin its Pallas adjoint to); the slot
layout (tests/test_torch_pose_grad_paths.py holds the polychromatic
merit, the interpret-mode Pallas adjoint and the adjoint alignment
compensator).  Tolerances are the reference's:
rtol 1e-9, atol 1e-12 (the wavefront rtol 1e-6, atol 1e-9); a row's
reverse 1e-12 of its largest value.  The kernels themselves run only on
a CUDA card (tests/test_torch_cuda.py)."""

import functools

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
import rayopt_tpu as J
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.ops.kernels import with_pose as jwith_pose
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT

RTOL, ATOL = 1e-9, 1e-12
ROT_FIELDS = CS.FIELDS + ("rot",)
ROT_OPD = CS.OPD_DIFF + ("rot",)
LAM = 587.56e-9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    yield
    set_default_device(old)


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    nptest.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                           err_msg=err_msg)


def _close_to_largest(got, want, rel, name):
    """got == want within `rel` of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    lim = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rel*lim, "%s: %.3e of the largest %.3e" % (name, err/lim,
                                                             lim)


def _bundle(s, n=128, seed=0):
    """The reference's adjoint-test bundle (tests/test_pallas_grad.py)."""
    rng = np.random.RandomState(seed)
    r = s.object.pupil.radius
    sl = s.object.pupil.slope
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*.8*r
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-1, 1, (n, 2))*.3*sl
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, n)
    w /= w.sum()
    return y, u, w


def _pose_setup(n=128):
    """The reference's pose setup: the doublet, its bundle, the specs
    with every row but the object's rotated and off axis."""
    js = jmodels.doublet()
    jt = js.table()
    y, u, w = _bundle(js, n)
    jspecs = jwith_pose(jspecialize(jt))
    return (js, jt, TT.table_from_numpy(jt), jspecs,
            TK.specs_from_tuple(jspecs), y, u, w)


def _poses(nsurf, at_zero):
    tilt = np.zeros((nsurf, 3))
    dec = np.zeros((nsurf, 3))
    if not at_zero:
        tilt[2, 0], tilt[3, 1] = 3e-3, -2e-3
        dec[1, 0], dec[2, 1] = .05, -.03
    return tilt, dec


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the row reverses against autograd ------------------------------------

#: one rotated, decentred row a kind (row 1 of a three-row table)
ROWS = {
    "sphere": {},
    "conic": dict(conic=-.6),
    "aspheric": dict(aspherics=(2e-5, -3e-8)),
    "biconic": dict(curvature_dx=.01, conic_dx=-.3),
    "toroid": dict(curvature_dx=.01, toroidal=1.),
    "grating": dict(grating_dy=.05),
    "doe": dict(doe=(1e-3, -2e-6)),
    "freeform": dict(xy_poly=(0., 0., 1e-3, 5e-4, -2e-4)),
    "mirror": dict(mu=-1.),
}


def _row_table(kind):
    extra = ROWS[kind]
    s = 3
    rot = np.repeat(np.eye(3)[None], s, 0)
    rot[1] = TT.rodrigues(torch.tensor([.02, -.03, .01],
                                       dtype=torch.float64)).numpy()
    kw = dict(curvature=[0., .02, 0.], rot=rot,
              offset=[[0., 0., 0.], [.1, -.05, 0.], [0., 0., 30.]],
              mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
              n_after=[1., 1.5, 1.5])
    for f, v in extra.items():
        if f == "mu":
            kw["mu"] = [1., v, 1.]
        elif np.ndim(v):
            a = np.zeros((s, len(v)))
            a[1] = v
            kw[f] = a
        else:
            kw[f] = [0., v, 0.]
    return TT.make_table(**kw)


def _row_rays(n=96, seed=3):
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-6, 6, (n, 2))
    y[:, 2] = -1.
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-.1, .1, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    return tuple(_tensors(*y.T, *u.T))


@pytest.mark.parametrize("path", [False, True], ids=["k5", "k9"])
@pytest.mark.parametrize("kind", list(ROWS))
def test_row_rot_vjp_matches_autograd(kind, path):
    """The rotation cotangent of one rotated row's reverse (the model of
    step_vjp.cuh's rot_leave_vjp + rot_enter_vjp in surface_step_vjp,
    figured_step_vjp and anamorphic_step_vjp; with `path` K9's PATH
    form) summed over the live rays, against autograd of
    kernels.surface_step_spec: 1e-12 of the largest; the state
    cotangents are unchanged by the rot slots."""
    tab = _row_table(kind)
    spec = TK.specialize(tab)[1]
    assert spec.rotated and spec.off_axis
    state = _row_rays()
    row = tab.row(1)
    rot = row.rot.clone().requires_grad_()
    out, (_, _, _, topt) = TK.surface_step_spec(state, row._replace(rot=rot),
                                                spec, False)
    rng = np.random.RandomState(5)
    g = tuple(_tensors(*rng.normal(size=(6, state[0].shape[0]))))
    ct_path = _tensors(rng.normal(size=state[0].shape[0]))[0] if path \
        else None
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert int(live.sum()) > state[0].shape[0]//2
    total = sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g))
    if path:
        total = total + (torch.where(live, topt, 0.)*ct_path).sum()
    want, = torch.autograd.grad(total, [rot])
    outd = tuple(o.detach() for o in out)
    gs, pj = CG._step_vjp_reference(state, row, spec, g, ct_path, out=outd)
    got = torch.stack([torch.where(live, v, 0.).sum() for v in pj[-CG.ROT:]])
    _close_to_largest(got.numpy(), want.flatten().numpy(), 1e-12, kind)
    gs0, pj0 = CG._step_vjp_reference(state, row, spec, g, ct_path)
    assert len(pj) == len(pj0) + CG.ROT
    for a, b in zip(gs, gs0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("off_axis", [False, True])
def test_tail_rot_vjp_matches_autograd(off_axis):
    """The reference-sphere tail's reverse on a rotated image row (the
    model of sphere_tail_vjp's rot slots: the image row's frame entered
    from the state leaving row S-2) against autograd of _sphere_tail's
    q = ti n_image, lx and ly: 1e-12 of the largest."""
    tab = _row_table("sphere")
    rot = tab.rot.clone()
    rot[2] = TT.rodrigues(torch.tensor([-.01, .015, .02],
                                       dtype=torch.float64))
    off = tab.offset.clone()
    off[2] = torch.tensor([.2 if off_axis else 0., -.1 if off_axis else 0.,
                           30.], dtype=torch.float64)
    tab = tab.replace(rot=rot, offset=off)
    spec = TK.specialize(tab)[2]
    assert spec.rotated and spec.off_axis == off_axis
    state = _row_rays()
    img = tab.row(2)
    rl = img.rot.clone().requires_grad_()
    aux = torch.tensor([.1, -.2, .3, -40., 5e-4], dtype=torch.float64)
    o = CG._sphere_tail(state, img._replace(rot=rl), spec, aux)
    q = o.ti*img.n_before
    lx, ly = o.px + o.ti*o.dx, o.py + o.ti*o.dy
    live = torch.isfinite(q)
    assert int(live.sum()) > state[0].shape[0]//2
    cq, clx, cly = _tensors(*np.random.RandomState(7).normal(
        size=(3, state[0].shape[0])))
    total = sum((torch.where(live, v, 0.)*c).sum()
                for v, c in ((q, cq), (lx, clx), (ly, cly)))
    want, = torch.autograd.grad(total, [rl])
    od = CG._sphere_tail(state, img, spec, aux)
    _, pj, _ = CG._opd_tail_vjp_reference(img, spec, od, cq, clx, cly, state)
    got = torch.stack([torch.where(live, v, 0.).sum() for v in pj[-CG.ROT:]])
    _close_to_largest(got.numpy(), want.flatten().numpy(), 1e-12, "tail")


def _posed_cooke():
    """The Cooke with a tilted interior row, a tilted image row, a
    decentred row and a conic row, its specs with every pose live."""
    tab = jmodels.cooke_triplet().table()
    nsurf = tab.curvature.shape[0]
    tilt = np.zeros((nsurf, 3))
    tilt[3] = (.01, -.02, 0.)
    tilt[-1] = (.003, .002, 0.)
    dec = np.zeros((nsurf, 3))
    dec[5] = (.05, -.03, 0.)
    conic = np.asarray(tab.conic).copy()
    conic[2] = -.6
    tt = TT.lower_pose(TT.table_from_numpy(tab.replace(
        tilt=tilt, decenter=dec, conic=conic)))
    return tt, TK.with_pose(TK.specialize(tt))


def _state(y, u):
    return tuple(c.contiguous() for c in _tensors(*y.T, *u.T))


@pytest.mark.parametrize("kernel", ["k5", "k7", "k9"])
def test_by_hand_models_with_rot_match_plain(kernel):
    """The K5, K7 and K9 models in torch with the rot slots (each rotated
    row's from the state leaving it, the image row's with the moment
    frame's second use, K9's from the sphere tail) against their autograd
    plain versions on the posed Cooke: every column within 1e-12 of its
    largest, the ray cotangents rtol 1e-9; the rot columns are the last
    ROT, nonzero on the rotated rows only."""
    tt, specs = _posed_cooke()
    js = jmodels.cooke_triplet()
    y, u, w = _bundle(js, 128, seed=2)
    state = _state(y, u)
    wt = torch.from_numpy(w)
    ct = torch.from_numpy(np.random.RandomState(1).normal(size=5))
    if kernel == "k5":
        a = CG.merit_adjoint_reference(tt, specs, state, wt, ct, rot=True)
        b = CG._merit_adjoint_by_hand(tt, specs, state, wt, ct, rot=True)
    elif kernel == "k7":
        tabs = TT.stack_tables([tt, tt.replace(mu=tt.mu*1.01)])
        ct = torch.from_numpy(np.random.RandomState(1).normal(size=(2, 5)))
        a = CG.merit_adjoint_multi_reference(tabs, specs, state, wt, ct,
                                             rot=True)
        b = CG._merit_adjoint_multi_by_hand(tabs, specs, state, wt, ct,
                                            rot=True)
    else:
        s = js
        from rayopt_tpu_torch.ops.geometric import trace_rays_final
        yr, _, _ = trace_rays_final(tt, torch.from_numpy(y[:1]),
                                    torch.from_numpy(u[:1]), specs=specs)
        aux = torch.cat([yr[0], torch.tensor(
            [-float(s.image.pupil.distance), LAM/1e-3],
            dtype=torch.float64)])
        cts = tuple(_tensors(*np.random.RandomState(4).normal(size=(3, 128))))
        a = CG.opd_adjoint_reference(tt, specs, state, aux, cts, rot=True)
        b = CG._opd_adjoint_by_hand(tt, specs, state, aux, cts, rot=True)
        _close(b[2], a[2], "centre", atol=1e-12*float(a[2].abs().max()))
    pa, pb = a[0].numpy(), b[0].numpy()
    lim = np.maximum(np.abs(pa).reshape(-1, pa.shape[-1]).max(0), 1e-300)
    assert float((np.abs(pb - pa)/lim).max()) <= 1e-12
    rot = pa[..., -CG.ROT:]
    rows = [j for j, sp in enumerate(specs) if sp.rotated]
    assert np.abs(rot[..., rows, :]).max() > 0
    assert not rot[..., [j for j in range(len(specs)) if j not in rows],
                   :].any()
    for g, r in zip(b[1], a[1]):
        _close(g, r, "state", atol=1e-12*float(r.abs().max()))


# -- the merits' pose gradients against the JAX package -------------------

@functools.lru_cache(maxsize=None)
def _spot_reference():
    """value_and_grad over (tilt, decenter) of the JAX package's XLA
    specialized spot RMS on _pose_setup's specs, jitted once for both
    poses (the table and the bundle are arguments: as constants XLA
    would fold the unrolled trace at compile time)."""
    jspecs = _pose_setup()[3]

    def loss_ref(jt, y, u, w, tilt, dec):
        return JGR.spot_rms(jt.replace(tilt=tilt, decenter=dec), y, u, w,
                            specs=jspecs, unroll=True)
    return jax.jit(jax.value_and_grad(loss_ref, argnums=(4, 5)))


@pytest.mark.parametrize("at_zero", [True, False], ids=["nominal", "posed"])
def test_adjoint_spot_rms_pose_grad_matches_jax(at_zero):
    """d(spot RMS)/d(tilt, decenter) through K4/K5's plain versions (the
    rot key's slots) == the JAX package's XLA specialized engine
    (spot_rms(specs=, unroll=True), which its tests pin both to central
    differences and to its Pallas adjoint), at the nominal pose
    (with_pose keeps it live) and at a perturbed one; row 0's tilt
    gradient is zero in both."""
    js, jt, tt, jspecs, specs, y, u, w = _pose_setup()
    tilt0, dec0 = _poses(jt.curvature.shape[0], at_zero)
    v1, (gt1, gd1) = _spot_reference()(jt, y, u, w, jnp.asarray(tilt0),
                                       jnp.asarray(dec0))
    tilt, dec = (t.requires_grad_() for t in _tensors(tilt0, dec0))
    v2 = CG.adjoint_spot_rms(tt.replace(tilt=tilt, decenter=dec),
                             *_tensors(y, u, w), specs=specs)
    v2.backward()
    _close(v2, float(v1), "value")
    for name, got, want in (("tilt", tilt.grad, gt1),
                            ("decenter", dec.grad, gd1)):
        want = np.asarray(want)
        assert np.abs(want[1:]).max() > 0, name
        _close(got, want, name)
    assert not tilt.grad[0].any() and not np.asarray(gt1)[0].any()


@functools.lru_cache(maxsize=None)
def _wavefront_setup():
    """tests/test_torch_wavefront.py's wavefront case: the doublet with
    tilted exit and image surfaces, defocused by 1 mm, its hexapolar
    bundle at field .5 padded to 128 rays at zero weight, the reference
    sphere at the exit pupil; and value_and_grad over (tilt, decenter)
    of the JAX package's XLA specialized wavefront RMS there, every pose
    live, jitted once for both poses (the table and the bundle are its
    arguments, not constants to fold)."""
    js = jmodels.doublet()
    js[-1].angles = (.05, .02, 0.)
    js[-2].angles = (.03, 0., 0.)
    js[-1].distance += 1.
    js.update()
    jg = J.GeometricTrace(js)
    jg.rays_point((0, .5), nrays=50, distribution="hexapolar", filter=False)
    n = len(jg.y[0])
    y = np.concatenate([jg.y[0], np.repeat(jg.y[0][:1], 128 - n, 0)])
    u = np.concatenate([jg.u[0], np.repeat(jg.u[0][:1], 128 - n, 0)])
    w = np.concatenate([np.full(n, 1./n), np.zeros(128 - n)])
    jt = js.table(jg.l)
    kw = dict(ref=jg.ref, radius=-js.image.pupil.distance, wavelength=jg.l,
              scale=js.scale, finite=js.object.finite)
    jspecs = jwith_pose(jspecialize(jt))

    def loss_ref(jt, y, u, w, tilt, dec):
        return JGR.wavefront_rms(jt.replace(tilt=tilt, decenter=dec), y, u,
                                 w, specs=jspecs, unroll=True, **kw)
    return (jt, y, u, w, kw, jspecs,
            jax.jit(jax.value_and_grad(loss_ref, argnums=(4, 5))))


@pytest.mark.parametrize("at_zero", [True, False], ids=["nominal", "posed"])
def test_adjoint_wavefront_pose_grad_matches_jax(at_zero):
    """d(wavefront RMS)/d(tilt, decenter) through K8/K9's plain versions
    (the rot key's slots, the image row's from the sphere tail; the
    sphere centre's one-ray trace by autograd) == the JAX package's XLA
    wavefront_rms(specs=, unroll=True) with every pose live: rtol 1e-6,
    atol 1e-9, as the reference's own test of its Pallas adjoint, and
    the value within 1e-9 waves (the per-ray OPD tolerance of
    tests/test_torch_wavefront.py); row 0's tilt gradient is zero."""
    jt, y, u, w, kw, jspecs, reference = _wavefront_setup()
    tilt0, dec0 = _poses(jt.curvature.shape[0], at_zero)
    v1, (gt1, gd1) = reference(jt, y, u, w, jnp.asarray(tilt0),
                               jnp.asarray(dec0))
    tilt, dec = (t.requires_grad_() for t in _tensors(tilt0, dec0))
    v2 = CG.adjoint_wavefront_rms(
        TT.table_from_numpy(jt).replace(tilt=tilt, decenter=dec),
        *_tensors(y, u, w), specs=TK.specs_from_tuple(jspecs), **kw)
    v2.backward()
    _close(v2, float(v1), "value", rtol=0, atol=1e-9)
    for name, got, want in (("tilt", tilt.grad, gt1),
                            ("decenter", dec.grad, gd1)):
        want = np.asarray(want)
        assert np.abs(want[1:]).max() > 0, name
        _close(got, want, name, rtol=1e-6, atol=1e-9)
    assert not tilt.grad[0].any()


# -- the slot layout ------------------------------------------------------

def test_rot_slots_are_last_and_live_on_rotated_rows():
    """A rot key ("rot" asked for and a row but the object's rotated,
    cuda_spec.carries_rot) has ROT slots more a row, last, live on the
    rotated rows only (K9's image row too), its own key name and the
    RAYOPT_ROT define; without "rot", or with no rotated row, the key is
    the one it was.  Every layout before the rot slots keeps its
    offsets."""
    tt, specs = _posed_cooke()
    nominal = TK.specialize(tt)
    for kernel, make, fields, base in (
            ("k5", CS.adjoint_key, ROT_FIELDS, CS.SLOTS),
            ("k7", CS.adjoint_multi_key, ROT_FIELDS, CS.SLOTS),
            ("k9", CS.opd_adjoint_key, ROT_OPD, CS.OPD_SLOTS)):
        plain = make(nominal, torch.float64, fields=fields[:-1])
        key = make(nominal, torch.float64, fields=fields)
        assert key.rot and not plain.rot and key.name != plain.name
        assert key.slots == plain.slots + CS.ROT == base + CS.ROT
        assert "#define RAYOPT_ROT 1" in CS.translation_unit(key)
        assert "RAYOPT_ROT" not in CS.translation_unit(plain)
        assert key.dynamic_smem == plain.dynamic_smem + \
            6*key.block*key.word_bytes
        rot_bits = ((1 << CS.ROT) - 1) << base
        for j, (a, b) in enumerate(zip(key.words, plain.words)):
            live = a >> CS.LIVE_SHIFT
            assert live & ~rot_bits == b >> CS.LIVE_SHIFT
            want = rot_bits if j and nominal[j].rotated else 0
            assert live & rot_bits == want, (kernel, j)
        # with no rotated row, "rot" changes nothing
        flat = tuple(s._replace(rotated=False) for s in nominal)
        assert make(flat, torch.float64, fields=fields) == \
            make(flat, torch.float64, fields=fields[:-1])
    assert CS.carries_rot(specs, ROT_FIELDS)
    assert not CS.carries_rot(specs, CS.FIELDS)
    # row 0 alone rotated: no rot slot anywhere
    only0 = tuple(s._replace(rotated=bool(j == 0))
                  for j, s in enumerate(nominal))
    assert not CS.carries_rot(only0, ROT_FIELDS)
    # the image row's tail reads its rotation
    m9 = CS.opd_live_slots(specs, ("rot",))
    assert m9[-1] == ((1 << CS.ROT) - 1) << CS.OPD_SLOTS and m9[0] == 0
    # the models' and the wrappers' column counts
    assert CG._nslots(tt, specs, rot=True) == CG._nslots(tt, specs) + CS.ROT


def test_rot_keys_are_refused_past_live_bits():
    """The nine rot slots count against a row word's LIVE_BITS (46; the
    reference has no such limit): a degree-7 freeform key (35 XY slots)
    fits without them and is refused with them, naming the count and the
    limit."""
    nxy = 35
    xy = np.zeros((3, nxy))
    xy[1, 3] = 1e-4
    tab = TT.make_table(curvature=[0., .02, 0.], xy_poly=xy,
                        offset=[[0., 0., 0.], [0., 0., 0.], [0., 0., 10.]],
                        mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
                        n_after=[1., 1.5, 1.5])
    specs = TK.with_pose(TK.specialize(tab))
    assert CS.adjoint_key(specs, torch.float64, fields=CS.FIELDS,
                          nxy=nxy).slots == CS.SLOTS + nxy
    with pytest.raises(ValueError, match=r"50 slots a row, above the 46"):
        CS.adjoint_key(specs, torch.float64, fields=ROT_FIELDS, nxy=nxy)
    with pytest.raises(ValueError, match=r"rotation slots"):
        CS.opd_adjoint_key(specs, torch.float64, fields=ROT_OPD, nxy=nxy)


def test_wrappers_take_rot_on_the_cpu():
    """merit_adjoint, merit_adjoint_multi and opd_adjoint with "rot" in
    `fields` run their plain versions on a CPU bundle with the rot
    columns last (live on the rotated rows), equal to the models', and
    count no launch."""
    tt, specs = _posed_cooke()
    js = jmodels.cooke_triplet()
    y, u, w = _bundle(js, 128, seed=2)
    state = _state(y, u)
    wt = torch.from_numpy(w)
    ct = torch.from_numpy(np.random.RandomState(1).normal(size=5))
    before = (CG.merit_adjoint.launches, CG.merit_adjoint_multi.launches)
    pg, st, gw = CG.merit_adjoint(tt, specs, state, wt, ct,
                                  fields=("offset", "rot"))
    ref = CG._merit_adjoint_by_hand(tt, specs, state, wt, ct, rot=True)[0]
    live = CS.live_mask(CS.live_slots(specs, ("offset", "rot")),
                        pg.shape[-1])
    _close_to_largest(pg.numpy(), torch.where(live, ref, 0.).numpy(), 1e-12,
                      "k5")
    assert pg[:, :2].abs().max() == 0 and pg[:, -CS.ROT:].abs().max() > 0
    tabs = TT.stack_tables([tt, tt])
    pgm, _, _ = CG.merit_adjoint_multi(tabs, specs, state, wt,
                                       torch.stack([ct, ct]),
                                       fields=("rot",))
    assert pgm.shape == (2, len(specs), CG._nslots(tt, specs, rot=True))
    _close(pgm[0, :, -CS.ROT:], ref[:, -CS.ROT:],
           atol=1e-12*float(ref.abs().max()))
    assert (CG.merit_adjoint.launches,
            CG.merit_adjoint_multi.launches) == before
