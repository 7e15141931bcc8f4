"""The port's P3P and vec6 gradients against dsac_tpu.

  * the P3P gradient with respect to the four scene points
    (geometry/p3p.py, with the reference's four gradient cuts) against
    jax.grad of solve_pnp_minimal: cosine >= 0.99 per set where both solve
    the set to the same pose; every set the port solves against its own
    f64 twin at the same bar; finite on duplicate-point and collinear
    sets;
  * pose_to_vec6 and pose_from_vec6 gradients to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dsac_tpu.config import Camera as JCamera
from dsac_tpu.geometry.p3p import solve_pnp_minimal as jax_p3p
from dsac_tpu.geometry.pose import Pose as JPose
from dsac_tpu.geometry.pose import pose_from_vec6 as jax_from_vec6
from dsac_tpu.geometry.pose import pose_to_vec6 as jax_to_vec6
from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.p3p import solve_pnp_minimal
from dsac_tpu_torch.geometry.pose import (Pose, compose, identity_pose,
                                          invert, pose_from_vec6,
                                          pose_to_vec6)
from dsac_tpu_torch.geometry.rotation import so3_exp
from test_torch_train import cosine_ratio
from torch_problems import one_torch_thread  # noqa: F401

JCAM = JCamera.make(525.0, 640, 480)
CAM = Camera.make(525.0, 640, 480)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def p3p_sets(rng, M):
    """M four-point sets seen from random poses at exact projections."""
    w = rng.normal(size=(M, 3)) * 0.3
    R = so3_exp(T(w)).numpy()
    t = np.stack([rng.normal(size=M) * 100, rng.normal(size=M) * 100,
                  -2500 + rng.normal(size=M) * 200], -1).astype(np.float32)
    eye = np.stack([rng.uniform(-900, 900, (M, 4)),
                    rng.uniform(-700, 700, (M, 4)),
                    -rng.uniform(1500, 4000, (M, 4))], -1)
    pix = np.stack([-525.0 * eye[..., 0] / eye[..., 2] + 320.0,
                    525.0 * eye[..., 1] / eye[..., 2] + 240.0], -1)
    obj = np.einsum("mji,mnj->mni", R, eye - t[:, None])
    return obj.astype(np.float32), pix.astype(np.float32)


def test_p3p_gradient_matches_reference(rng):
    """Where both solve the set to the same pose.  On an ill-conditioned
    set the two f32 solvers may serve poses mm apart (set 44 of these
    draws: 6 mm); there the port's gradient is the one that agrees with
    its f64 twin (cosine 0.9999 against the reference's 0.888), and every
    set the port solves is held to that twin."""
    M = 48
    obj, pix = p3p_sets(rng, M)
    w = rng.normal(size=(M, 6)).astype(np.float32)

    def jloss(o):
        p, v = jax.vmap(lambda a, b: jax_p3p(a, b, JCAM))(o, jnp.asarray(pix))
        return jnp.sum(jnp.asarray(w) * jax_to_vec6(p)), (p, v)

    jg, (jp, jv) = jax.jit(jax.grad(jloss, has_aux=True))(jnp.asarray(obj))
    o = T(obj).requires_grad_()
    p, valid = solve_pnp_minimal(o, T(pix), CAM)
    (T(w) * pose_to_vec6(p)).sum().backward()
    # the same solution on both sides: solved by both, poses within 0.1 mm
    same = (valid.numpy() & np.asarray(jv)
            & (np.abs(p.t.detach().numpy() - np.asarray(jp.t)).max(-1) < 0.1))
    assert same.mean() >= 0.9
    for m in np.flatnonzero(same):
        cos, _ = cosine_ratio(o.grad[m].numpy(), np.asarray(jg[m]))
        assert cos >= 0.99, (m, cos)
    # every set the port solves, against its own f64 twin
    o64 = torch.from_numpy(obj.astype(np.float64)).requires_grad_()
    p64, _ = solve_pnp_minimal(o64, torch.from_numpy(pix.astype(np.float64)),
                               CAM)
    (torch.from_numpy(w.astype(np.float64)) * pose_to_vec6(p64)
     ).sum().backward()
    for m in np.flatnonzero(valid.numpy()):
        cos, _ = cosine_ratio(o.grad[m].numpy(), o64.grad[m].numpy())
        assert cos >= 0.99, (m, cos)


def test_p3p_gradient_finite_on_degenerate_sets(rng):
    obj, pix = p3p_sets(rng, 8)
    obj[:4, 1], pix[:4, 1] = obj[:4, 0], pix[:4, 0]  # a duplicated point
    d = obj[4:, 1] - obj[4:, 0]
    obj[4:, 2] = obj[4:, 0] + 2.5 * d  # three collinear points
    o = T(obj).requires_grad_()
    p, _ = solve_pnp_minimal(o, T(pix), CAM)
    assert torch.isfinite(p.R).all() and torch.isfinite(p.t).all()
    pose_to_vec6(p).sum().backward()
    assert torch.isfinite(o.grad).all()


def test_vec6_gradients_match_reference(rng):
    """Including the small-angle branches of so3_log (|v| < 1e-6) and
    so3_exp (theta^2 < 1e-8).  pose_from_vec6 is compared at angles in
    the Taylor branch and at O(1) angles: between them (theta ~ 1e-3),
    (1 - cos theta) / theta^2 cancels in f32 on both sides, and its
    derivative is the two libraries' cos rounding (3.8e-5 apart)."""
    v = rng.normal(size=(6, 6)).astype(np.float32)
    v[:2, :3] *= 1e-7
    v[2:4, :3] *= 1e-3
    Rs = so3_exp(T(v[:, :3])).numpy()
    w6 = rng.normal(size=(6, 6)).astype(np.float32)
    wR = rng.normal(size=(6, 3, 3)).astype(np.float32)

    jR, jt = jax.grad(lambda R, t: jnp.sum(
        jnp.asarray(w6) * jax_to_vec6(JPose(R, t))), argnums=(0, 1))(
        jnp.asarray(Rs), jnp.asarray(v[:, 3:]))
    R = T(Rs).requires_grad_()
    t = T(v[:, 3:]).requires_grad_()
    (T(w6) * pose_to_vec6(Pose(R, t))).sum().backward()
    np.testing.assert_allclose(R.grad.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt), atol=1e-5)

    def jfrom(x):
        p = jax_from_vec6(x)
        return jnp.sum(jnp.asarray(wR) * p.R) + jnp.sum(
            jnp.asarray(w6[:, :3]) * p.t)

    v[2:4, :3] *= 1e-2  # into the Taylor branch
    jv = jax.grad(jfrom)(jnp.asarray(v))
    x = T(v).requires_grad_()
    p = pose_from_vec6(x)
    ((T(wR) * p.R).sum() + (T(w6[:, :3]) * p.t).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jv), atol=1e-5)


def test_compose_and_identity(rng):
    a = pose_from_vec6(T(rng.normal(size=(4, 6))))
    b = pose_from_vec6(T(rng.normal(size=(4, 6))))
    x = T(rng.normal(size=(4, 3)))
    ab = compose(a, b)
    torch.testing.assert_close((ab.R @ x[..., None])[..., 0] + ab.t,
                               (a.R @ ((b.R @ x[..., None])[..., 0]
                                       + b.t)[..., None])[..., 0] + a.t)
    ident = compose(a, invert(a))
    eye = identity_pose((4,))
    torch.testing.assert_close(ident.R, eye.R, atol=1e-6, rtol=0)
    torch.testing.assert_close(ident.t, eye.t, atol=1e-5, rtol=0)
