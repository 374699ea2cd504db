"""The port's Trainer checkpoints, restores and recovers, on the CPU: the
counterparts of ``tests/test_trainer_integration.py``'s restart and
failure-injection tests and ``tests/test_chaos.py``'s injected step fault,
at reduced qwen2_0_5b (f32, two layers) with the parameters the JAX package
initialises, batch 2 x 32, at most 6 steps a trainer.

A restore copies into the tensors the trainer holds: the restored trainer's
next loss equals the uninterrupted one's (tolerance 1e-5 relative, as the
JAX tests hold; on one CPU it is bit for bit), and every leaf equals the
checkpoint's host copy bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels._build import CudaError, KernelUnavailable  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.testing import FaultPlan, FaultRule  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.checkpoint import flatten_with_paths  # noqa: E402

CFG = get_config("qwen2_0_5b").reduced()
RUN = RunConfig(remat="none", loss_chunk=16, q_chunk=16, k_chunk=16)
DATA = DataConfig(seed=0, batch_size=2, seq_len=32)
OPT = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60, grad_clip=1.0)
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    params, _ = jlm.init_params(jax.random.PRNGKey(0), j_get_config("qwen2_0_5b").reduced())
    return jax.tree_util.tree_map(np.asarray, params)


def make_trainer(tmp_path, jax_params=None, steps=6, every=3, async_ckpt=False):
    params = (from_jax_params(jax_params, CFG, device="cpu") if jax_params is not None
              else None)
    return Trainer(CFG, RUN, DATA, OPT,
                   TrainerConfig(total_steps=steps, checkpoint_every=every,
                                 checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_keep=2,
                                 async_checkpoint=async_ckpt),
                   device="cpu", params=params)


def _losses(metrics):
    return [m["loss"] for m in metrics]


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
def test_checkpoint_restart_exact(tmp_path, jax_params, async_ckpt):
    tr = make_trainer(tmp_path, jax_params, async_ckpt=async_ckpt)
    for _ in range(3):                      # the checkpoint fires at step 3
        tr.run_one_step()
    after3 = tr.run_one_step()["loss"]      # the 4th step from the live state
    tr.ckpt.wait()

    tr2 = make_trainer(tmp_path, jax_params, async_ckpt=async_ckpt)
    held = list(tr2._leaves)
    assert tr2.restore_checkpoint() == 3
    assert tr2.step == 3 and tr2.data.step == tr.data.step - 1
    assert tr2.opt_state["step"] == 3
    # in place: the trainer's leaves and state lists are the same tensors
    assert all(a is b for a, b in zip(held, adamw.leaves(tr2.params)))
    # every leaf equals the checkpoint's host copy, bit for bit
    host = tr2.ckpt.load(3, tr2._state_tree())
    for (path, live), (_, arr, _) in zip(flatten_with_paths(tr2._state_tree()), host):
        if isinstance(live, torch.Tensor):
            assert np.array_equal(live.detach().numpy(), arr), path
        else:
            assert live == int(arr), path
    replay = tr2.run_one_step()["loss"]
    assert abs(after3 - replay) <= TOL * abs(after3), (after3, replay)


def test_failure_injection_recovers(tmp_path, jax_params):
    tr = make_trainer(tmp_path, jax_params, steps=6, every=2)
    fired = {"done": False}

    def fail_hook(step):
        if step == 3 and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected failure")

    metrics = tr.train(fail_hook=fail_hook)
    assert fired["done"] and tr.step == 6
    assert tr.ckpt.latest_step() in (4, 6)
    # each step index once, from its last run
    assert len(metrics) == 6 and all(np.isfinite(_losses(metrics)))


def test_injected_step_faults_recover_to_same_loss(tmp_path, jax_params):
    clean = make_trainer(tmp_path / "clean", jax_params)
    clean_losses = _losses([clean.run_one_step() for _ in range(6)])

    chaotic = make_trainer(tmp_path / "chaos", jax_params, async_ckpt=True)
    plan = FaultPlan([FaultRule(site="train.step:4", times=1, message="injected node loss")])
    with plan, obs.collect(name="chaos") as col:
        metrics = chaotic.train()
    assert plan.count("train.step:4") == 1, "the drill must fire"
    assert chaotic.step == 6 and chaotic.ckpt.all_steps() == [3, 6]
    # the recovery is not hidden: one warning, one count
    warned = [w for w in col.events("warning") if w["name"] == "train.recovered"]
    assert chaotic.recoveries == 1 and len(warned) == 1 and warned[0]["step"] == 4
    assert "injected node loss" in warned[0]["error"]
    # restore and replay reconverge on the uninterrupted trajectory
    np.testing.assert_allclose(_losses(metrics), clean_losses, rtol=TOL)


def test_restart_from_scratch_reinitialises_from_the_seed(tmp_path):
    """With no checkpoint, a trainer that made its own parameters restarts
    from ``tcfg.seed`` and retraces the clean run."""
    clean = make_trainer(tmp_path / "clean", steps=3, every=10)
    clean_losses = _losses(clean.train())
    tr = make_trainer(tmp_path / "scratch", steps=3, every=10)
    with FaultPlan([FaultRule(site="train.step:2", times=1)]) as plan:
        metrics = tr.train()
    assert plan.count() == 1 and tr.ckpt.all_steps() == []
    np.testing.assert_allclose(_losses(metrics), clean_losses, rtol=TOL)
    assert tr.opt_state["step"] == 3


def test_reinit_params_in_place_equals_a_fresh_init():
    """The restart from scratch's re-init, a piece at a time into the live
    tree, draws the numbers ``lm.init_params`` draws, bit for bit."""
    live = lm.init_params(CFG, 5, "cpu")
    held = adamw.leaves(live)
    for t in held:
        t.add_(1.0)
    lm.reinit_params_(live, CFG, 7)
    want = adamw.leaves(lm.init_params(CFG, 7, "cpu"))
    assert all(a is b for a, b in zip(held, adamw.leaves(live)))
    for a, b in zip(held, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("error", [
    KernelUnavailable("rmsnorm: no kernel on this host"),
    CudaError(7, "rmsnorm: CUDA error 7 (too many resources requested for launch)"),
], ids=["unavailable", "refused"])
def test_errors_no_guard_absorbs_raise_out_of_train(tmp_path, error):
    """A kernel missing on this host or a launch the card refused is never
    recovered by a restore and replay: it raises out of ``train()`` the
    first time, with no recovery counted or warned."""
    tr = make_trainer(tmp_path, steps=3, every=1)
    calls = []

    def fail_hook(step):
        calls.append(step)
        if step == 1:
            raise error

    with obs.collect(name="fatal") as col, pytest.raises(type(error)):
        tr.train(fail_hook=fail_hook)
    assert calls == [0, 1] and tr.recoveries == 0
    assert not [w for w in col.events("warning") if w["name"] == "train.recovered"]


def test_restart_from_scratch_refuses_handed_parameters(tmp_path, jax_params):
    """A trainer handed ``params=`` keeps no copy of them: with no
    checkpoint to restore it raises rather than train from other
    weights."""
    tr = make_trainer(tmp_path, jax_params, steps=3, every=10)
    with FaultPlan([FaultRule(site="train.step:1", times=1)]):
        with pytest.raises(RuntimeError, match="cannot restart from scratch"):
            tr.train()


def test_the_launcher_resumes_from_its_checkpoint_dir(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--batch", "2", "--seq",
            "16", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    train_launcher.main(argv + ["--steps", "2"])
    first = capsys.readouterr().out
    assert "resumed" not in first and "step 2: loss" in first
    train_launcher.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from the checkpoint at step 2" in out
    assert "step 3: loss" in out and "step 1: loss" not in out
    assert "trained qwen2-0.5b on cpu: 3 steps" in out
