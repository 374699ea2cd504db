"""Hybrid (Mamba) training in the port against the JAX package's, on the
CPU: reduced Jamba-1.5-Large (one attention and seven Mamba layers a
super-block, two super-blocks, f32), without experts and with them (an MoE
FFN every second layer, 4 experts top-2).

The JAX ``init_params`` output and the JAX pipeline's batches cross through
numpy. Held against JAX:

* ``loss_fn`` (the loss, its cross entropy and the MoE aux loss) and every
  gradient leaf, in kernel mode (JAX: Pallas in interpret mode and its
  ``ssm_scan_bwd``; port: the kernels' plain versions, the scan's gradient
  through the dispatched ``ssm_scan_bwd``) and in reference mode;
* two AdamW steps of the port's ``Trainer`` against JAX's losses and
  parameters;
* ``remat="full"`` recomputes the reference path's gradients (the card's
  step-1 gate takes that path), and the launcher trains the arch on the CPU.

The kernel-mode loss and gradients run in ``test_torch_hybrid_train_kernel.py``
and, with experts, ``test_torch_hybrid_train_experts_kernel.py``; the other
cases with experts in ``test_torch_hybrid_train_experts.py``: four files on
four workers.

Tolerances: loss 1e-5 relative; each gradient leaf 3e-5 of its max|JAX|
(1e-4 for the routers, as in ``test_torch_moe.py``). Both sides compute in
fp32 through 16 layers; the Mamba leaves' gradients are sums over b * s
steps of a recurrence taken in another order (JAX differentiates an
associative scan, the port walks the adjoint step by step): readings up to
1e-5. Parameters after two trainer steps, each leaf's max difference in
units of the summed learning rates: the median leaf within 5e-2, as for the
dense model, every leaf within 0.25. Adam divides each gradient element by
its own running rms, so an element whose gradient is a few fp32 steps
from zero moves by up to lr on a last-digit difference (``test_torch_train.py``);
the Mamba projections have such elements: ``x_proj`` reads 0.14, in the
reference mode as in the kernel mode.
"""
import dataclasses

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
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

JRUN = JRun(remat="none", q_chunk=16, k_chunk=16, loss_chunk=32)
RUN = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=32)
TOL_LOSS = 1e-5
TOL_GRAD = 3e-5
TOL_ROUTER = 1e-4
TOL_STEP_MEDIAN = 5e-2
TOL_STEP_MAX = 0.25


def _model(experts: bool):
    over = {} if experts else dict(num_experts=0, experts_per_token=0)
    jcfg = dataclasses.replace(j_get_config("jamba_1_5_large").reduced(), **over)
    cfg = dataclasses.replace(get_config("jamba_1_5_large").reduced(), **over)
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, params


@pytest.fixture(scope="module", params=[False], ids=["dense"])
def jamba(request):
    """Without experts here; with them in test_torch_hybrid_train_experts.py,
    which runs these cases on a worker of its own."""
    return _model(request.param)


_STEPS = {}


def _jax_step(jcfg):
    """JAX's ``value_and_grad(loss_fn)`` in reference mode, jitted once a
    model: the reference-mode loss test and the trainer test share it."""
    if jcfg not in _STEPS:
        with repro.runtime(mode="reference"):       # read while tracing: one trace
            _STEPS[jcfg] = jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss_fn(p, b, jcfg, JRUN), has_aux=True))
    return _STEPS[jcfg]


def _port_params(model):
    _, cfg, params = model
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def _close(t, j, tol):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max() if t.size else 0.0
    assert err <= tol * max(np.abs(j).max() if j.size else 0.0, 1e-6), err


@pytest.mark.parametrize("mode", ["reference"])    # kernel: test_torch_hybrid_train_kernel.py
def test_loss_and_every_gradient_leaf_match_jax(jamba, mode):
    check_loss_and_every_gradient_leaf(jamba, mode)


def check_loss_and_every_gradient_leaf(jamba, mode):
    jcfg, cfg, params = jamba
    batch = JPipe(jcfg, JData(seed=1, batch_size=2, seq_len=24)).next_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with repro.runtime(mode=mode):
        if mode == "reference":
            (j_loss, j_aux), j_grads = _jax_step(jcfg)(params, jb)
        else:
            (j_loss, j_aux), j_grads = jax.value_and_grad(
                lambda p: jlm.loss_fn(p, jb, jcfg, JRUN), has_aux=True)(params)
    tp = _port_params(jamba)
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_()
    with repro_torch.runtime(mode=mode) as rt:
        loss, aux = lm.loss_fn(tp, batch_to_tensors(batch, "cpu"), cfg, RUN)
        grads = torch.autograd.grad(loss, leaves)
    _close(loss, j_loss, TOL_LOSS)
    _close(aux["xent"], j_aux["xent"], TOL_LOSS)
    _close(aux["aux"], j_aux["aux"], TOL_LOSS)
    assert (float(aux["aux"].detach()) > 0) == (cfg.num_experts > 0)
    names = [n for n, _ in adamw.named_leaves(tp)]
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), cfg,
                                            device="cpu"))
    assert len(j_leaves) == len(grads) == len(names)
    assert sum(n.endswith("/mixer/A_log") for n in names) == 14      # every Mamba layer
    for name, g, jg in zip(names, grads, j_leaves):
        _close(g, jg.numpy(), TOL_ROUTER if name.endswith("router") else TOL_GRAD)
    if mode == "kernel":
        snap = rt.telemetry.snapshot()
        bwd = {k.split("|")[0] for k in snap["by_key_phase"]["bwd"]}
        want = {"matmul", "rmsnorm_bwd", "softmax_xent_bwd", "flash_attention_bwd",
                "ssm_scan_bwd"} | ({"expert_gemm"} if cfg.num_experts else set())
        assert bwd == want
        assert "reference" not in snap["tiers"]


def test_two_trainer_steps_match_jax(jamba):
    jcfg, cfg, params = jamba
    opt = dict(lr=2e-3, warmup_steps=1, total_steps=2)
    data = dict(seed=4, batch_size=2, seq_len=24)
    jopt = jadamw.AdamWConfig(**opt)
    jstate, jp, pipe = jadamw.init(jopt, params), params, JPipe(jcfg, JData(**data))
    with repro.runtime(mode="reference"):
        step = _jax_step(jcfg)
        j_losses = []
        for _ in range(2):
            (loss, _), g = step(jp, {k: jnp.asarray(v) for k, v in pipe.next_batch().items()})
            jp, jstate, _ = jadamw.update(jopt, g, jstate, jp)
            j_losses.append(float(loss))
    trainer = Trainer(cfg, RUN, DataConfig(**data), adamw.AdamWConfig(**opt),
                      TrainerConfig(total_steps=2), runtime=repro_torch.runtime(),
                      device="cpu", params=_port_params(jamba))
    metrics = trainer.train()
    np.testing.assert_allclose([m["loss"] for m in metrics], j_losses, rtol=TOL_LOSS)
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                            device="cpu"))
    lr_sum = sum(m["lr"] for m in metrics)
    errs = sorted(np.abs(p.detach().numpy() - jl.numpy()).max()
                  for p, jl in zip(adamw.leaves(trainer.params), j_leaves))
    assert errs[len(errs) // 2] <= TOL_STEP_MEDIAN * lr_sum
    assert errs[-1] <= TOL_STEP_MAX * lr_sum
    phases = trainer.runtime.telemetry.snapshot()["by_key_phase"]
    assert any(k.startswith("ssm_scan_bwd|") for k in phases["bwd"])


def test_remat_full_recomputes_the_reference_gradients(jamba):
    jcfg, cfg, _ = jamba
    batch = batch_to_tensors(JPipe(jcfg, JData(seed=6, batch_size=2, seq_len=24)).next_batch(),
                             "cpu")
    grads = {}
    for remat in ("none", "full"):
        run = RunConfig(remat=remat, q_chunk=16, k_chunk=16, loss_chunk=32)
        tr = Trainer(cfg, run, DataConfig(batch_size=2, seq_len=24), device="cpu",
                     params=_port_params(jamba), runtime=repro_torch.runtime(mode="reference"))
        grads[remat] = tr.loss_and_grads(batch)
    _close(grads["full"][0], grads["none"][0].numpy(), TOL_LOSS)
    for a, b in zip(grads["full"][1], grads["none"][1]):
        _close(a, b.numpy(), TOL_GRAD)


def test_train_launcher_trains_jamba_on_the_cpu(capsys):
    train_launcher.main(["--arch", "jamba_1_5_large", "--smoke", "--steps", "2", "--device",
                         "cpu", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "2 steps of 2 x 16 tokens" in out and "phase bwd" in out
