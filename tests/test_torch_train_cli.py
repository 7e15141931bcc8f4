"""The port's training entry points (dsac_tpu_torch.cli.train_ransac and
train_ransac_softam), its snapshots (utils/checkpoint.py), its training
log (utils/logging.py) and its npz writer (utils/params_io.py), on the
CPU at the smallest size the flags allow (--width-mult 0.125: a
DenseCoordNet of width 8 and a ScoreNet of width 8; 16 hypotheses), with
every file under pytest's temporary directory.

Bars: every round finite with a finite coordinate gradient; a resumed run
continues the round count, the optimizer states and the view schedule, so
its next round equals the uninterrupted run's to 1e-5; a net written by
save_params_npz and read by the reference's load_params_npz gives Flax's
forward the port's own, at the coordinate net's bar (atol 0.03 m, mean
under 5 mm; tests/test_torch_coord_net.py) and, for a ScoreNet in f32,
at rtol 1e-5 / atol 1e-5 (tests/test_torch_score_net.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.models.coord_net import DenseCoordNet as FlaxCoordNet
from dsac_tpu.models.score_net import ScoreNet as FlaxScoreNet
from dsac_tpu.utils.params_io import load_params_npz as jax_load_npz
from dsac_tpu_torch.cli import train_ransac, train_ransac_softam
from dsac_tpu_torch.models import DenseCoordNet, ScoreNet, init_like_flax
from dsac_tpu_torch.utils import checkpoint as ckpt
from dsac_tpu_torch.utils.logging import TrainingLog
from dsac_tpu_torch.utils.params_io import (load_coord_net_npz,
                                            load_params_npz,
                                            save_params_npz,
                                            score_net_from_flax)
from torch_problems import one_torch_thread  # noqa: F401

SMALL = ["--width-mult", "0.125", "--hypotheses", "16", "--synthetic", "4",
         "--device", "cpu"]


def run(out, rounds, *extra, softam=False):
    main = train_ransac_softam.main if softam else train_ransac.main
    return main(SMALL + ["--rounds", str(rounds), "--out", str(out),
                         *extra])


@pytest.mark.parametrize("softam", [False, True], ids=["dsac", "softam"])
def test_two_rounds_snapshot_and_validate(tmp_path, softam):
    res = run(tmp_path, 2, "--snapshot-every", "1", "--validate-every", "2",
              "--validate-frames", "1", softam=softam)
    assert res["objective"] == ("softam" if softam else "e2e")
    assert res["refine_mode"] == "unroll"  # auto on the CPU
    assert [r["round"] for r in res["rounds"]] == [0, 1]
    for r in res["rounds"]:
        assert np.isfinite(r["objective"]) and r["grad_finite"]
        assert r["valid_hyps"] <= 16
    assert res["snapshots"] == [1, 2]
    obj = ckpt.OBJ_SOFTAM if softam else ckpt.OBJ_E2E
    assert ckpt.latest_step(tmp_path, obj) == 2
    assert ckpt.latest_step(tmp_path, obj + "_best") == 2
    snap = ckpt.restore(tmp_path, obj)
    net = DenseCoordNet(width=8)
    net.load_state_dict(snap["params"])
    assert snap["step"] == 2 and "state" in snap["opt_state"]
    tag = "softam" if softam else "e2e"
    lines = (tmp_path / f"ransac_training_loss_{tag}.txt").read_text(
        ).splitlines()
    assert [int(x.split()[0]) for x in lines] == [0, 1]


def test_resume_continues_rounds_and_view_schedule(tmp_path):
    whole = run(tmp_path / "whole", 2, "--snapshot-every", "1")
    first = run(tmp_path / "split", 1, "--snapshot-every", "1")
    rest = run(tmp_path / "split", 2, "--snapshot-every", "1")
    assert rest["start_round"] == 1
    assert [r["round"] for r in rest["rounds"]] == [1]
    np.testing.assert_allclose(
        [r["objective"] for r in first["rounds"] + rest["rounds"]],
        [r["objective"] for r in whole["rounds"]], rtol=1e-5)
    side = json.loads((tmp_path / "split" /
                       f"rng_state_{ckpt.OBJ_E2E}.json").read_text())
    assert side["round"] == 2
    assert ckpt.restore(tmp_path / "split", ckpt.SCORE_E2E)["step"] == 2


def test_init_snapshots_are_loaded(tmp_path):
    net = init_like_flax(DenseCoordNet(width=8),
                         torch.Generator().manual_seed(5))
    ckpt.save(tmp_path, ckpt.OBJ_INIT, {"params": net.state_dict()})
    res = run(tmp_path, 1)
    loaded = DenseCoordNet(width=8)
    loaded.load_state_dict(ckpt.restore(tmp_path, ckpt.OBJ_E2E)["params"])
    # one SGD step of 1e-5 from the init snapshot, not from a fresh init
    delta = max(float((a - b).abs().max().detach()) for a, b in
                zip(loaded.parameters(), net.parameters()))
    assert 0.0 < delta < 1e-3
    assert np.isfinite(res["rounds"][0]["objective"])


def test_flags_not_ported_are_refused(tmp_path):
    for flag in (["--mesh", "1x2"], ["--steps-per-call", "4"],
                 ["--score-head", "soft"], ["--stage-frames", "8"],
                 ["--score-temp", "2"]):
        with pytest.raises(SystemExit):
            run(tmp_path, 1, *flag)


@pytest.mark.parametrize("softam", [False, True], ids=["dsac", "softam"])
def test_flags_not_ported_are_refused_from_the_shell(monkeypatch, softam):
    """From the shell main() gets argv=None and reads sys.argv: the refused
    flag gets the "not ported" message, not argparse's rejection."""
    main = train_ransac_softam.main if softam else train_ransac.main
    monkeypatch.setattr("sys.argv", ["train_ransac", "--mesh", "1x2"])
    with pytest.raises(SystemExit) as exc:
        main()
    assert str(exc.value) == ("--mesh: not ported to dsac_tpu_torch "
                              "(ROADMAP.md)")


def test_checkpoint_keeps_the_newest_and_writes_atomically(tmp_path):
    for step in range(5):
        ckpt.save(tmp_path, "x", {"step": step, "w": torch.ones(2) * step},
                  step=step, keep=2)
    assert sorted(p.name for p in (tmp_path / "x").iterdir()) == \
        ["3.pt", "4.pt"]
    assert ckpt.latest_step(tmp_path, "x") == 4
    assert ckpt.restore(tmp_path, "x", step=3)["step"] == 3
    assert ckpt.latest_step(tmp_path, "missing") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, "missing")


def test_training_log_layout(tmp_path):
    with TrainingLog(tmp_path / "log.txt") as log:
        log.append(3, 1.5, {"entropy": 2.0})
    assert (tmp_path / "log.txt").read_text() == "3 1.500000 2.000000\n"


def test_params_npz_round_trip_serves_in_the_reference(tmp_path):
    """Port -> npz (f16) -> the reference's load_params_npz -> Flax's
    forward equals the port's forward of the same npz."""
    gen = torch.Generator().manual_seed(3)
    net = init_like_flax(DenseCoordNet(width=16), gen)
    path = tmp_path / "coord.npz"
    save_params_npz(path, net)
    assert all(v.dtype == np.float16 for v in load_params_npz(path).values())
    rng = np.random.default_rng(1305)
    image = (rng.random((1, 64, 96, 3)) * 255).astype(np.float32)
    flax_net = FlaxCoordNet(width=16)
    template = flax_net.init(jax.random.PRNGKey(0), jnp.asarray(image))
    ref = np.asarray(flax_net.apply(jax_load_npz(path, template),
                                    jnp.asarray(image)), np.float32)
    with torch.no_grad():
        got = load_coord_net_npz(path, "cpu")(torch.from_numpy(image))
    np.testing.assert_allclose(got.numpy(), ref, atol=0.03)
    assert np.abs(got.numpy() - ref).mean() < 0.005
    # f16 storage: the port's weights come back to f16 precision
    for a, b in zip(load_coord_net_npz(path, "cpu").parameters(),
                    net.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)

    score = init_like_flax(ScoreNet(width_mult=0.25, dtype=torch.float32),
                           gen)
    save_params_npz(tmp_path / "score.npz", score)
    maps = (rng.random((4, 40, 40)) * 100).astype(np.float32)
    flax_score = FlaxScoreNet(dtype=jnp.float32, width_mult=0.25)
    template = flax_score.init(jax.random.PRNGKey(0), jnp.asarray(maps))
    ref = np.asarray(flax_score.apply(
        jax_load_npz(tmp_path / "score.npz", template), jnp.asarray(maps)))
    port = score_net_from_flax(load_params_npz(tmp_path / "score.npz"),
                               dtype=torch.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(maps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
