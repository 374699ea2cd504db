"""The two frontends against the JAX package, on the CPU: MusicGen's
``audio_frames`` (frame embeddings in place of tokens) and PaliGemma's
``vision_patches`` (patch embeddings before the tokens, the loss masked off
them), at the reduced configs in f32, with the JAX parameters and the JAX
pipeline's batches carried across through numpy.

Held against JAX: the forward's hidden state, the masked loss and every
gradient leaf, in kernel mode (JAX: Pallas in interpret mode; the port:
its kernels' plain versions) and in reference mode; prefill's sequence
length and logits for a prefix batch (the patches count in the cache);
the mask's effect (labels under the prefix change nothing). The engine
refuses both frontends, as the JAX engine does, and so does the serving
launcher.

Tolerances as ``test_torch_arch_smoke.py``: the hidden state, loss and
logits 1e-5 of max|JAX|, each gradient leaf 3e-5 of its max|JAX|.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import batch_to_tensors, from_jax_params  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

JRUN = JRun(remat="none", q_chunk=16, k_chunk=16, loss_chunk=16, microbatches=1)
RUN = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=16)
TOL = 1e-5
TOL_GRAD = 3e-5
FRONTENDS = {"audio_frames": "musicgen_large", "vision_patches": "paligemma_3b"}


@pytest.fixture(scope="module", params=sorted(FRONTENDS))
def model(request):
    arch = FRONTENDS[request.param]
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return request.param, jcfg, cfg, params, tparams


def _close(t, j, tol):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    assert np.abs(t - j).max() <= tol * max(np.abs(j).max(), 1e-6)


def test_pipelines_draw_the_same_batches(model):
    frontend, jcfg, cfg, _, _ = model
    data = dict(seed=3, batch_size=2, seq_len=24)
    jb = JPipe(jcfg, JData(**data)).next_batch()
    tb = SyntheticPipeline(cfg, DataConfig(**data)).next_batch()
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k])
    if frontend == "vision_patches":
        assert tb["embeds"].shape == (2, cfg.num_prefix, cfg.d_model)
        assert tb["tokens"].shape == (2, 24 - cfg.num_prefix)
        assert (tb["loss_mask"][:, :cfg.num_prefix] == 0).all()
    else:
        assert tb["embeds"].shape == (2, 24, cfg.d_model) and "tokens" not in tb


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_forward_masked_loss_and_gradients_match_jax(model, mode):
    frontend, jcfg, cfg, params, tparams = model
    batch = JPipe(jcfg, JData(seed=5, batch_size=2, seq_len=24)).next_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = batch_to_tensors(batch, "cpu")
    with repro.runtime(mode=mode):
        jx, _, _ = jlm.forward(params, jb, jcfg, JRUN, mode="train")
        (j_loss, _), j_grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jb, jcfg, JRUN), has_aux=True)(params)
    leaves = adamw.leaves(tparams)
    for p in leaves:
        p.requires_grad_()
    with repro_torch.runtime(mode=mode):
        tx, _, _ = lm.forward(tparams, tb, cfg, RUN, mode="train")
        loss, _ = lm.loss_fn(tparams, tb, cfg, RUN)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert tx.shape == (2, 24, cfg.d_model)
    _close(tx, jx, TOL)
    _close(loss, j_loss, TOL)
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), cfg,
                                            device="cpu"))
    for (name, p), g, jg in zip(adamw.named_leaves(tparams), grads, j_leaves):
        if g is None:           # audio frames: the token table is never read
            assert frontend == "audio_frames" and name == "/embed/table"
            assert not jg.abs().max()
            continue
        _close(g, jg.numpy(), TOL_GRAD)


def test_labels_under_the_prefix_change_nothing():
    """The loss mask is zero on the patches: their labels never count."""
    cfg = get_config("paligemma_3b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    b = batch_to_tensors(SyntheticPipeline(cfg, DataConfig(seed=2, batch_size=2,
                                                           seq_len=16)).next_batch(), "cpu")
    with torch.no_grad():
        base, _ = lm.loss_fn(params, b, cfg, RUN)
        b["labels"][:, :cfg.num_prefix] = (b["labels"][:, :cfg.num_prefix] + 7) % cfg.vocab_size
        moved, _ = lm.loss_fn(params, b, cfg, RUN)
        b["labels"][:, -1] = (b["labels"][:, -1] + 7) % cfg.vocab_size
        last, _ = lm.loss_fn(params, b, cfg, RUN)
    assert float(moved) == float(base) and float(last) != float(base)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_prefill_of_a_prefix_batch_matches_jax(model, mode):
    """Prefill's sequence is the patches plus the tokens (or the frames):
    the caches hold that many rows, the logits are JAX's."""
    frontend, jcfg, cfg, params, tparams = model
    rs = np.random.RandomState(9)
    P, T = cfg.num_prefix, 11
    seq = P + T if frontend == "vision_patches" else T
    batch = {"embeds": rs.randn(1, P if frontend == "vision_patches" else T,
                                cfg.d_model).astype(np.float32)}
    if frontend == "vision_patches":
        batch["tokens"] = rs.randint(0, cfg.vocab_size, (1, T)).astype(np.int32)
    with repro.runtime(mode=mode):
        jl, jc = jlm.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, JRUN)
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        tl, tc = lm.prefill(tparams, batch_to_tensors(batch, "cpu"), cfg, RUN)
    assert tc[0]["l0"]["k"].shape[2] == seq == np.asarray(jc[0]["l0"]["k"]).shape[2]
    _close(tl, jl, TOL)
    for name in ("k", "v"):
        _close(tc[0]["l0"][name], jc[0]["l0"][name], TOL)


@pytest.mark.parametrize("arch", sorted(FRONTENDS.values()))
def test_the_engine_and_the_serving_launcher_refuse_a_frontend(arch, capsys):
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="token-in/token-out"):
        ServingEngine(cfg, RunConfig(), params, EngineConfig(max_batch=2, max_seq=32))
    with pytest.raises(SystemExit):
        serve_launcher.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert "engine serves token-in/token-out archs only" in capsys.readouterr().err
