"""Pose gradients through the port's analytic adjoints K5 and K7, in
float64 on the CPU (the rest: tests/test_torch_pose_grad.py): the union
polychromatic merit's d/d(tilt, decenter) through K6/K7's plain versions
against the JAX package's XLA engine, adjoint_spot_rms against the JAX
package's interpret-mode Pallas adjoint, and optimize_grad(select=
("tilt", "decenter"), engine="adjoint") against the JAX package's same
call.  Tolerances are the reference's: rtol 1e-9, atol 1e-12.  The
kernels themselves run only on a CUDA card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from rayopt_tpu import glass as JGL
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.ops.kernels import with_pose as jwith_pose
from rayopt_tpu.ops.pallas_grad import pallas_spot_rms
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_pose_grad import _bundle, _close, _pose_setup, _poses, \
    _tensors


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    yield
    set_default_device(old)


def test_adjoint_pose_grad_matches_pallas_interpret():
    """One posed case against the JAX package's Pallas adjoint itself
    (interpret mode, tile 128): the value and d/d(tilt, decenter)."""
    js, jt, tt, jspecs, specs, y, u, w = _pose_setup()
    tilt0, dec0 = _poses(jt.curvature.shape[0], False)

    def loss_pal(jt, y, u, w, tilt, dec):
        return pallas_spot_rms(jt.replace(tilt=tilt, decenter=dec), y, u, w,
                               specs=jspecs, tile=128, interpret=True)

    # jitted with the table and the bundle as arguments, as the
    # polychromatic reference below
    v1, (gt1, gd1) = jax.jit(jax.value_and_grad(loss_pal, argnums=(4, 5)))(
        jt, y, u, w, jnp.asarray(tilt0), jnp.asarray(dec0))
    tilt, dec = (t.requires_grad_() for t in _tensors(tilt0, dec0))
    v2 = CG.adjoint_spot_rms(tt.replace(tilt=tilt, decenter=dec),
                             *_tensors(y, u, w), specs=specs)
    v2.backward()
    _close(v2, float(v1), "value")
    _close(tilt.grad, gt1, "tilt")
    _close(dec.grad, gd1, "decenter")


def test_polychromatic_pose_grad_matches_jax():
    """d(union spot RMS)/d(tilt, decenter) through K6/K7's plain versions
    (each table's rot slots; autograd through the stacked lower_pose sums
    them) == the JAX package's XLA polychromatic merit on the doublet's
    three wavelength tables, at a perturbed pose."""
    js = jmodels.doublet()
    jts = js.tables()
    nlam, nsurf = jts.curvature.shape
    jspecs = jwith_pose(jspecialize(js.table()))
    specs = TK.specs_from_tuple(jspecs)
    y, u, w = _bundle(js)
    tilt0, dec0 = _poses(nsurf, False)

    def loss_ref(jts, y, u, w, tilt, dec):
        return JGL.polychromatic_spot_rms(
            jts.replace(tilt=jnp.stack([tilt]*nlam),
                        decenter=jnp.stack([dec]*nlam)),
            y, u, w, specs=jspecs)

    # jitted with the stack and the bundle as arguments: it compiles in
    # less time than the eager trace takes (as constants XLA would fold
    # the unrolled trace at compile time)
    v1, (gt1, gd1) = jax.jit(jax.value_and_grad(loss_ref, argnums=(4, 5)))(
        jts, y, u, w, jnp.asarray(tilt0), jnp.asarray(dec0))
    tts = TT.table_from_numpy(jts)
    tilt, dec = (t.requires_grad_() for t in _tensors(tilt0, dec0))
    v2 = CG.polychromatic_spot_rms(
        tts.replace(tilt=torch.stack([tilt]*nlam),
                    decenter=torch.stack([dec]*nlam)),
        *_tensors(y, u, w), specs=specs)
    v2.backward()
    _close(v2, float(v1), "value")
    for name, got, want in (("tilt", tilt.grad, gt1),
                            ("decenter", dec.grad, gd1)):
        assert np.abs(np.asarray(want)[1:]).max() > 0, name
        _close(got, want, name)


def test_optimize_grad_adjoint_pose_matches_jax():
    """optimize_grad(select=("tilt", "decenter"), engine="adjoint") --
    the alignment compensator on the adjoint engine, K4/K5's plain
    versions here -- against the JAX package's same call (its Pallas
    adjoint in interpret mode), two Adam steps from a misaligned
    surface: the histories (rtol 1e-9) and the poses agree.  The poses
    take rtol 1e-9 with atol 1e-6 lr: Adam divides each component by its
    own root mean square plus eps = 1e-8, so a component whose gradient
    is rounding noise near eps (a tilt about the axis of this
    rotationally symmetric lens) moves by lr times a ratio that the two
    packages round differently."""
    js = jmodels.doublet()
    jt = js.table()
    nsurf = jt.curvature.shape[0]
    tilt = np.zeros((nsurf, 3))
    tilt[2, 0] = 5e-3
    jt = jt.replace(tilt=jnp.asarray(tilt))
    y, u, w = _bundle(js)
    sel = ("tilt", "decenter")
    jt1, jh = JGR.optimize_grad(jt, [(y, u, w)], select=sel, steps=2,
                                optimizer=optax.adam(3e-4), engine="adjoint",
                                tile=128, interpret=True)
    tt1, th = TGR.optimize_grad(TT.table_from_numpy(jt), [_tensors(y, u, w)],
                                select=sel, steps=2, lr=3e-4,
                                engine="adjoint")
    assert th[-1] < th[0]
    _close(th, jh)
    for k in sel:
        _close(getattr(tt1, k), getattr(jt1, k), k, atol=1e-6*3e-4)
