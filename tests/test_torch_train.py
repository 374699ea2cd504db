"""The port's training path against the JAX package's, at reduced qwen2_0_5b
(f32, two layers), on the CPU.

The JAX ``init_params`` output and the JAX pipeline's batches cross through
numpy; the port's ``loss_fn`` and every gradient leaf must give JAX's
``jax.value_and_grad(lm.loss_fn)`` in kernel mode (JAX: Pallas in interpret
mode; port: each kernel's plain version, differentiated through the
dispatch plane's backward kernels) and in reference mode, and three AdamW
steps of the port's trainer must give JAX's losses and parameters.

Tolerances: loss and gradients 1e-5 of the largest magnitude (the same
fp32 math, sums in another order). One AdamW update from the same
gradients: 1e-6 absolute (fp32 arithmetic of parameters near 1). Parameters
after three trainer steps: 5e-2 of the summed learning rates. Adam divides
each gradient element by its own running rms, so an element whose gradient
is a near-cancelling sum moves by up to 2 lr on a last-digit difference;
the k-projection bias is such a leaf (under RoPE its score terms nearly
cancel across keys) and differs by about 1.4% of the summed rates, every
other leaf by under 0.2%.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import batch_to_tensors, from_jax_params  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

JRUN = JRun(remat="none", q_chunk=16, k_chunk=16, loss_chunk=32)
RUN = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=32)
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("qwen2_0_5b").reduced()
    cfg = get_config("qwen2_0_5b").reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, params


def _port_params(model):
    jcfg, cfg, params = model
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def _close(t, j, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= tol * max(np.abs(j).max(), 1e-6), err


_STEPS = {}


def _jax_step(jcfg):
    """JAX's ``value_and_grad(loss_fn)`` in reference mode, jitted once: the
    optimizer tests share it (both at batch 2 x 32)."""
    if jcfg not in _STEPS:
        with repro.runtime(mode="reference"):       # read while tracing: one trace
            _STEPS[jcfg] = jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss_fn(p, b, jcfg, JRUN), has_aux=True))
    return _STEPS[jcfg]


def _jax_value_and_grad(model, mode, batch):
    jcfg, _, params = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with repro.runtime(mode=mode) as rt:
        (loss, _), grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jb, jcfg, JRUN), has_aux=True)(params)
    return loss, grads, rt


@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 2, 48), (3, 5, 4, 33)])
def test_pipeline_batches_are_byte_equal_to_jax(model, seed, step, batch, seq):
    jcfg, cfg, _ = model
    jp = JPipe(jcfg, JData(seed=seed, batch_size=batch, seq_len=seq), step=step)
    tp = SyntheticPipeline(cfg, DataConfig(seed=seed, batch_size=batch, seq_len=seq), step=step)
    for _ in range(2):
        jb, tb = jp.next_batch(), tp.next_batch()
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == tb[k].tobytes()
    assert tp.state_dict() == jp.state_dict()


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_loss_and_every_gradient_leaf_match_jax(model, mode):
    jcfg, cfg, _ = model
    batch = JPipe(jcfg, JData(seed=1, batch_size=2, seq_len=48)).next_batch()
    j_loss, j_grads, _ = _jax_value_and_grad(model, mode, batch)
    params = _port_params(model)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_()
    with repro_torch.runtime(mode=mode):
        loss, aux = lm.loss_fn(params, batch_to_tensors(batch, "cpu"), cfg, RUN)
        grads = torch.autograd.grad(loss, leaves)
    _close(loss, j_loss)
    assert float(aux["aux"]) == 0.0 and torch.equal(aux["xent"], loss)
    # JAX's gradient tree in the port's layout (layers unstacked), same leaf order
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), cfg,
                                            device="cpu"))
    assert len(j_leaves) == len(grads) == 2 * 12 + 3
    for g, jg in zip(grads, j_leaves):
        _close(g, jg.numpy())


def _kernels_by_phase(telemetry_by_key_phase, phase):
    return {"|".join(k.split("|")[:1] + k.split("|")[2:])            # drop the platform
            for k in telemetry_by_key_phase.get(phase, {})}


def test_backward_resolves_the_jax_keys_in_phase_bwd(model):
    """Every gradient of the step is a dispatch site in phase bwd, with the
    JAX package's keys: the transposed matmul calls and all three *_bwd
    tunables (platform aside)."""
    jcfg, cfg, _ = model
    batch = JPipe(jcfg, JData(seed=2, batch_size=2, seq_len=32)).next_batch()
    _, _, jrt = _jax_value_and_grad(model, "kernel", batch)
    params = _port_params(model)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_()
    with repro_torch.runtime() as rt:
        loss, _ = lm.loss_fn(params, batch_to_tensors(batch, "cpu"), cfg, RUN)
        torch.autograd.grad(loss, leaves)
    j_snap, t_snap = jrt.telemetry.snapshot(), rt.telemetry.snapshot()
    for phase in ("fwd", "bwd"):
        assert _kernels_by_phase(t_snap["by_key_phase"], phase) == \
            _kernels_by_phase(j_snap["by_key_phase"], phase)
    bwd = _kernels_by_phase(t_snap["by_key_phase"], "bwd")
    assert {k.split("|")[0] for k in bwd} == {"matmul", "rmsnorm_bwd", "softmax_xent_bwd",
                                              "flash_attention_bwd"}
    # dL/dw of the unembed: x^T [d, rows] @ ct [rows, vocab]
    assert "matmul|64x64/64x256|float32" in bwd
    assert set(t_snap["phases"]["bwd"]) == {"heuristic"}


def test_three_adamw_steps_match_jax(model):
    jcfg, cfg, params = model
    opt = dict(lr=2e-3, warmup_steps=2, total_steps=3)
    data = dict(seed=4, batch_size=2, seq_len=32)
    # JAX: value_and_grad in reference mode (the same function as its
    # kernel mode, held above) and adamw.update, on its pipeline's batches
    jopt = jadamw.AdamWConfig(**opt)
    jstate, jp, pipe = jadamw.init(jopt, params), params, JPipe(jcfg, JData(**data))
    with repro.runtime(mode="reference"):
        step = _jax_step(jcfg)
        j_losses = []
        for _ in range(3):
            (loss, _), g = step(jp, {k: jnp.asarray(v) for k, v in pipe.next_batch().items()})
            jp, jstate, _ = jadamw.update(jopt, g, jstate, jp)
            j_losses.append(float(loss))
    trainer = Trainer(cfg, RUN, DataConfig(**data), adamw.AdamWConfig(**opt),
                      TrainerConfig(total_steps=3), runtime=repro_torch.runtime(),
                      device="cpu", params=_port_params(model))
    metrics = trainer.train()
    np.testing.assert_allclose([m["loss"] for m in metrics], j_losses, rtol=TOL)
    assert [m["lr"] for m in metrics] == pytest.approx([1e-3, 2e-3, 2e-4], rel=1e-6)
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                            device="cpu"))
    tol = 5e-2 * sum(m["lr"] for m in metrics)
    for p, jl in zip(adamw.leaves(trainer.params), j_leaves):
        assert np.abs(p.detach().numpy() - jl.numpy()).max() <= tol
    assert set(trainer.runtime.telemetry.phases) == {"fwd", "bwd"}   # no dispatch in opt


def test_one_adamw_update_from_the_same_gradients_matches_jax(model):
    """The optimizer alone: JAX's gradients into both packages' update."""
    jcfg, cfg, params = model
    batch = JPipe(jcfg, JData(seed=7, batch_size=2, seq_len=32)).next_batch()
    with repro.runtime(mode="reference"):
        _, j_grads = _jax_step(jcfg)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jopt = jadamw.AdamWConfig(**opt)
    jstate = jadamw.init(jopt, params)
    for _ in range(2):                        # the second step reads m, v and the bias fixes
        jp, jstate, jm = jadamw.update(jopt, j_grads, jstate, params)
    tparams = _port_params(model)
    grads = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), cfg,
                                         device="cpu"))
    state = adamw.init(adamw.AdamWConfig(**opt), tparams)
    for _ in range(2):
        _, state, tm = adamw.update(adamw.AdamWConfig(**opt), grads, state, tparams)
    assert state["step"] == 2 and tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                            device="cpu"))
    for p, jl in zip(adamw.leaves(tparams), j_leaves):
        assert np.abs(p.numpy() - jl.numpy()).max() <= 1e-6


def test_microbatches_accumulate_to_the_full_batch(model):
    """Two microbatches of equal token counts average to the full batch's
    mean loss and gradients (fp32 accumulation; sums in another order)."""
    jcfg, cfg, _ = model
    batch = batch_to_tensors(JPipe(jcfg, JData(seed=5, batch_size=4, seq_len=32)).next_batch(),
                             "cpu")
    out = {}
    for k in (1, 2):
        tr = Trainer(cfg, RunConfig(q_chunk=16, k_chunk=16, loss_chunk=32, microbatches=k),
                     DataConfig(batch_size=4, seq_len=32), device="cpu",
                     params=_port_params(model))
        out[k] = tr.loss_and_grads(batch)
    _close(out[2][0], out[1][0].numpy())
    for g2, g1 in zip(out[2][1], out[1][1]):
        _close(g2, g1.numpy())


def test_remat_full_recomputes_the_same_gradients(model):
    jcfg, cfg, _ = model
    batch = batch_to_tensors(JPipe(jcfg, JData(seed=6, batch_size=2, seq_len=32)).next_batch(),
                             "cpu")
    grads = {}
    for remat in ("none", "full"):
        run = RunConfig(remat=remat, q_chunk=16, k_chunk=16, loss_chunk=32)
        tr = Trainer(cfg, run, DataConfig(batch_size=2, seq_len=32), device="cpu",
                     params=_port_params(model), runtime=repro_torch.runtime())
        grads[remat] = tr.loss_and_grads(batch)[1]
        # the recompute runs under the trainer's runtime: more fwd dispatches
        grads[remat + "_fwd"] = sum(tr.runtime.telemetry.phases["fwd"].values())
    for a, b in zip(grads["none"], grads["full"]):
        _close(a, b.numpy())
    assert grads["full_fwd"] > grads["none_fwd"]
    with pytest.raises(NotImplementedError):     # "dots" is ported (test_torch_dp_train.py)
        RunConfig(remat="offload")


def test_train_launcher_runs_on_the_cpu_when_asked(capsys):
    train_launcher.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "2", "--device", "cpu",
                         "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "trained qwen2-0.5b on cpu: 2 steps of 2 x 32 tokens" in out
    assert "phase fwd" in out and "phase bwd" in out and "kernel launches: {}" in out
