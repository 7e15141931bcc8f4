"""The port's end-to-end training (dsac_tpu_torch.pipeline.train) against
dsac_tpu.pipeline.train, DSAC objective.

The toy of tests/test_train.py:108-130: oracle scene coordinates of the
reference's SyntheticScene.frame(PRNGKey(7)) plus 5 mm of numpy noise and a
trainable 3-vector bias, scored by gain x soft-inlier count, H = 16
hypotheses of T = 16 attempts on the 40 x 40 grid.  The reference's draws
for PRNGKey(0) are injected through FrameDraws; the winner is the argmax.

Bars: the objective to 1e-2 relative + 0.2 (the expected-loss bar of
tests/test_torch_pipeline_cnn.py); the coordinate gradient cosine >= 0.99
and norm ratio 0.9-1.1.  The toy's score gradient is held only finite, as
tests/test_train.py holds it: its softmax is one-hot (score gaps of ~100
soft inliers, non-winner probabilities below f32's range), so d obj / d
gain is the f32 rounding of s_winner - E_p[s], ~ulp(800) x 21 ~ 1e-3, and
the reference's own jitted and eager evaluations give 2.0e-3 and -3.5e-6.
The score gradient is held at cosine >= 0.99 and ratio 0.9-1.1 in the
ScoreNet cases of tests/test_torch_train_scorenet*.py, for DSAC and SoftAM
in every refine mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsac_tpu.config import DSACConfig as JCfg
from dsac_tpu.config import PoseConfig as JPoseCfg
from dsac_tpu.data.synthetic import SyntheticScene as JScene
from dsac_tpu.ops import soft_inlier_scores as jax_soft_scores
from dsac_tpu.pipeline.train import e2e_expected_loss as jax_e2e
from dsac_tpu_torch.config import Camera, DSACConfig, PoseConfig
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.models.coord_net import DenseCoordNet, coord_apply
from dsac_tpu_torch.ops.diffmap import soft_inlier_scores
from dsac_tpu_torch.pipeline import FrameDraws
from dsac_tpu_torch.pipeline.train import (ClippedSGD, clamp_grad,
                                           coord_l1_loss,
                                           e2e_expected_loss, e2e_step,
                                           make_e2e_state, score_l1_loss)
from torch_problems import one_torch_thread  # noqa: F401

H, T, G = 16, 16, 40
BIAS = [150.0, -120.0, 100.0]


def cosine_ratio(a, b):
    """(cosine, |a| / |b|) of two arrays, in f64."""
    a = np.ravel(np.asarray(a, np.float64))
    b = np.ravel(np.asarray(b, np.float64))
    return (float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)),
            float(np.linalg.norm(a) / (np.linalg.norm(b) + 1e-30)))


class ToyCoord(torch.nn.Module):
    """Oracle coordinates plus noise plus a trainable bias (mm), in m."""

    def __init__(self, coords_gt, noise):
        super().__init__()
        self.register_buffer("coords_gt", torch.from_numpy(coords_gt))
        self.register_buffer("noise", torch.from_numpy(noise))
        self.bias = torch.nn.Parameter(torch.tensor(BIAS))

    def forward(self, images, pix):
        c = self.coords_gt[pix[..., 1], pix[..., 0]] + self.noise
        return (c + self.bias) / 1000.0


class ToyScore(torch.nn.Module):
    """gain x soft-inlier count of each map (beta 10)."""

    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.tensor(1.0))

    def forward(self, dm):
        return self.gain * soft_inlier_scores(dm.reshape(dm.shape[0], -1),
                                              10.0, 10.0)


def make_toy(noise_mm=5.0):
    """Both sides of the toy: a dict with the reference's closures,
    parameters, config and key, and the port's modules, draws, config,
    frame and ground truth."""
    scene = JScene()
    pose, rgb, _depth, coords_gt = scene.frame(jax.random.PRNGKey(7))
    noise = (np.random.default_rng(0).normal(size=(G * G, 3)) * noise_mm
             ).astype(np.float32)
    jnoise = jnp.asarray(noise)

    def coord_apply(params, image, pix):
        c = coords_gt[pix[:, 1], pix[:, 0]] + jnoise
        return (c + params["bias"]) / 1000.0

    def score_apply(params, dm):
        return params["gain"] * jax_soft_scores(dm.reshape(dm.shape[0], -1),
                                                10.0, 10.0)

    key = jax.random.PRNGKey(0)
    # the draws process_frame makes from `key` (forward.py:318, :97;
    # sampling.py:240, :110)
    k_front, _ = jax.random.split(key)
    k_samp, k_hyp = jax.random.split(k_front)
    kx, ky = jax.random.split(k_samp)
    jitter = np.stack([np.asarray(jax.random.uniform(kx, (G, G))),
                       np.asarray(jax.random.uniform(ky, (G, G)))])
    idx = np.asarray(jax.random.randint(k_hyp, (H, T, 4), 0, G * G))
    return dict(
        jrgb=rgb, jpose=pose, jcam=scene.camera, key=key,
        coord_apply=coord_apply, score_apply=score_apply,
        cp={"bias": jnp.asarray(BIAS)}, sp={"gain": jnp.asarray(1.0)},
        jcfg=JCfg(pose=JPoseCfg(num_hypotheses=H, random_draw=False)),
        coord=ToyCoord(np.array(coords_gt), noise), score=ToyScore(),
        draws=FrameDraws(
            jitter=torch.from_numpy(jitter[None].copy()),
            idx=torch.from_numpy(idx[None].copy()).to(torch.int64)),
        cfg=DSACConfig(pose=PoseConfig(num_hypotheses=H, random_draw=False)),
        cam=Camera.make(525.0, 640, 480),
        gt=Pose(torch.from_numpy(np.array(pose.R))[None],
                torch.from_numpy(np.array(pose.t))[None]),
        image=torch.zeros(1, 480, 640, 3))


def reference(toy, softam, mode, score_apply=None, sp=None, jit=True):
    """The reference's objective and (coord, score) gradients."""
    fn = functools.partial(
        jax.value_and_grad(jax_e2e, argnums=(0, 1), has_aux=True),
        coord_apply=toy["coord_apply"],
        score_apply=score_apply or toy["score_apply"], cam=toy["jcam"],
        cfg=toy["jcfg"], softam=softam, refine_mode=mode)
    fn = jax.jit(fn) if jit else fn
    (obj, _aux), (gc, gs) = fn(toy["cp"], toy["sp"] if sp is None else sp,
                               toy["key"], toy["jrgb"], toy["jpose"])
    return float(obj), np.asarray(gc["bias"]), gs


def port(toy, softam, mode, score_net=None):
    """The port's objective, aux and (coord, score) parameter gradients."""
    coord, score = toy["coord"], score_net or toy["score"]
    coord.zero_grad()
    score.zero_grad()
    obj, aux = e2e_expected_loss(coord, score, toy["image"], toy["gt"],
                                 toy["cam"], toy["cfg"], softam=softam,
                                 refine_mode=mode, draws=toy["draws"])
    obj.backward()
    return float(obj.detach()), aux, coord.bias.grad.numpy().copy(), {
        n: p.grad.clone() for n, p in score.named_parameters()}


def hold(got_obj, ref_obj, got_gc, ref_gc):
    assert abs(got_obj - ref_obj) <= 1e-2 * abs(ref_obj) + 0.2, \
        (got_obj, ref_obj)
    cos, ratio = cosine_ratio(got_gc, ref_gc)
    assert cos >= 0.99 and 0.9 <= ratio <= 1.1, (cos, ratio, got_gc, ref_gc)


@pytest.fixture(scope="module")
def toy():
    return make_toy()


@pytest.mark.parametrize("mode", [False, "implicit"],
                         ids=["unroll", "implicit"])
def test_dsac_objective_and_gradients_match_reference(toy, mode):
    ref_obj, ref_gc, ref_gs = reference(toy, False, mode)
    obj, aux, gc, gs = port(toy, False, mode)
    hold(obj, ref_obj, gc, ref_gc)
    assert np.isfinite(float(ref_gs["gain"]))
    assert torch.isfinite(gs["gain"]).all()
    assert obj > 5.0  # a 150 mm bias leaves the pose well off
    assert float(aux["valid_hyps"][0]) == H


def test_clamp_grad():
    x = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    y = clamp_grad(x, 0.1)
    torch.testing.assert_close(y, x)
    (y * torch.tensor([5.0, -5.0, 0.05])).sum().backward()
    torch.testing.assert_close(x.grad, torch.tensor([0.1, -0.1, 0.05]))


def test_losses():
    pred = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    gt = torch.tensor([[0.0, 3.0, 4.0], [1.0, 0.0, 0.0]])
    torch.testing.assert_close(coord_l1_loss(pred, gt), torch.tensor(2.5))
    torch.testing.assert_close(
        coord_l1_loss(pred, gt, torch.tensor([1.0, 0.0])), torch.tensor(5.0))
    torch.testing.assert_close(
        score_l1_loss(torch.tensor([1.0, -1.0]), torch.tensor([0.0, 1.0])),
        torch.tensor(1.5))


def test_optimizer_matches_optax():
    """Global-norm clipping at 10 and SGD with momentum 0.9, against
    optax's chain on the same random gradients over 3 steps; gradient
    norms below and above the clip."""
    rng = np.random.default_rng(1305)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = ClippedSGD(params, lr=0.05)
    ref = optax.chain(optax.clip_by_global_norm(10.0),
                      optax.sgd(0.05, momentum=0.9))
    jp = [jnp.asarray(a) for a in init]
    state = ref.init(jp)
    for scale in (1.0, 30.0, 3.0):
        grads = [(rng.normal(size=s) * scale).astype(np.float32)
                 for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = ref.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, r in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-7)


def test_e2e_step_updates_and_reports(toy):
    coord = ToyCoord(toy["coord"].coords_gt.numpy(),
                     toy["coord"].noise.numpy())
    state = make_e2e_state(coord, ToyScore())
    _, _, gc, _ = port(dict(toy, coord=ToyCoord(
        toy["coord"].coords_gt.numpy(), toy["coord"].noise.numpy())),
        False, False)
    state, loss, aux = e2e_step(state, toy["image"], toy["gt"], toy["cam"],
                                toy["cfg"],
                                coord_apply=lambda n, im, pix: n(im, pix),
                                draws=toy["draws"])
    assert state.step == 1 and np.isfinite(float(loss))
    assert bool(aux["grad_finite"])
    np.testing.assert_allclose(float(aux["grad_max"]), np.abs(gc).max(),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["grad_norm"]), np.linalg.norm(gc),
                               rtol=1e-5)
    # norm below the clip: one SGD step of 1e-5 from the bias, and the
    # momentum trace holds the raw gradient
    trace = state.coord_opt.state[coord.bias]["trace"].numpy()
    np.testing.assert_allclose(trace, gc, rtol=1e-5)
    np.testing.assert_allclose(coord.bias.detach().numpy(),
                               np.float32(BIAS) - np.float32(1e-5) * gc,
                               rtol=1e-6)


def test_score_anchor_reaches_score_params_only(toy):
    """tests/test_train.py:188-211: the anchor adds a positive L1 to the
    objective, changes the score gradient and leaves the coordinate
    gradient bit for bit."""
    def run(w):
        toy["coord"].zero_grad()
        toy["score"].zero_grad()
        obj, aux = e2e_expected_loss(toy["coord"], toy["score"],
                                     toy["image"], toy["gt"], toy["cam"],
                                     toy["cfg"], score_anchor=w,
                                     draws=toy["draws"])
        obj.backward()
        return (float(obj.detach()), float(aux["score_anchor_l1"][0]),
                toy["coord"].bias.grad.clone(),
                toy["score"].gain.grad.clone())

    obj0, anchor0, gc0, gs0 = run(0.0)
    obj1, anchor1, gc1, gs1 = run(0.25)
    assert anchor0 == 0.0 and anchor1 > 0.0
    np.testing.assert_allclose(obj1, obj0 + 0.25 * anchor1, rtol=1e-5)
    torch.testing.assert_close(gc0, gc1, rtol=0, atol=0)
    assert float(gs0) != float(gs1)


def test_bf16_layers_keep_f32_master_weights():
    """The coordinate net casts to bf16 per layer; its parameters stay f32
    leaves and their gradients arrive in f32, finite."""
    torch.manual_seed(0)
    net = DenseCoordNet(width=8)
    img = torch.rand(1, 64, 80, 3) * 255
    pix = torch.tensor([[[10, 20], [40, 33], [70, 60]]])
    coord_l1_loss(coord_apply(net, img, pix),
                  torch.zeros(1, 3, 3)).backward()
    for name, p in net.named_parameters():
        assert p.dtype == torch.float32 and p.is_leaf, name
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name
