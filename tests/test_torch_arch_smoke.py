"""Every arch the port registers against the JAX package, on the CPU: the
port of ``tests/test_arch_smoke.py`` for all ten archs.

Each arch at its reduced, family-preserving config in f32, with the JAX
``init_params`` output carried across through numpy:

* the forward's hidden state, the loss and every gradient leaf against
  JAX, in reference mode on both sides (the model-level math), and one
  AdamW step that changes the parameters;
* one arch in kernel mode (JAX: Pallas in interpret mode; the port: its
  kernels' plain versions through dispatch) at PaliGemma's attention
  geometry, heads of 256 on one kv head with its vision prefix, so the
  head dim the flash kernels gained is held end to end;
* decode after prefill against the full forward's next-token logits
  (qwen2_5_3b, gemma3_27b, Mixtral, xLSTM, Jamba: the JAX test's archs;
  the MoE archs with a capacity that drops nothing), Gemma3's windowed
  cache shapes, Arctic's MoE-plus-dense pattern, and parameter counts in
  the JAX test's ranges, counted on the meta device (xLSTM's 2.928 B
  exactly, its parts as the two mixers' inits give them).

Tolerances: loss 1e-5 relative and the hidden state 1e-5 of its max|JAX|
(the same fp32 math through 4 to 16 layers, sums in another order); each
gradient leaf 3e-5 of its max|JAX| (1e-4 for the routers, whose gradient
sums a softmax over experts), as ``test_torch_hybrid_train.py``; decode
against the full forward 2e-4, the JAX test's.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro_torch.configs import ARCH_NAMES, all_configs, get_config  # noqa: E402
from repro_torch.convert import batch_to_tensors, from_jax_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

JRUN = JRun(remat="none", loss_chunk=8, q_chunk=8, k_chunk=8, microbatches=1)
RUN = RunConfig(loss_chunk=8, q_chunk=8, k_chunk=8)
B, S = 2, 16
TOL = 1e-5
TOL_GRAD = 3e-5
TOL_ROUTER = 1e-4
TOL_DECODE = 2e-4


def make_batch(cfg, rs, seq=S):
    """The JAX test's batch, in numpy."""
    if cfg.frontend == "audio_frames":
        return {"embeds": rs.randn(B, seq, cfg.d_model).astype(np.float32),
                "labels": rs.randint(0, cfg.vocab_size, (B, seq)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        P = cfg.num_prefix
        mask = np.zeros((B, seq), np.float32)
        mask[:, P:] = 1
        return {"embeds": rs.randn(B, P, cfg.d_model).astype(np.float32),
                "tokens": rs.randint(0, cfg.vocab_size, (B, seq - P)).astype(np.int32),
                "labels": rs.randint(0, cfg.vocab_size, (B, seq)).astype(np.int32),
                "loss_mask": mask}
    return {"tokens": rs.randint(0, cfg.vocab_size, (B, seq)).astype(np.int32),
            "labels": rs.randint(0, cfg.vocab_size, (B, seq)).astype(np.int32)}


def _close(t, j, tol):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max() if t.size else 0.0
    assert err <= tol * max(np.abs(j).max() if j.size else 0.0, 1e-6), err


def _both(arch, **over):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _against_jax(jcfg, cfg, params, tparams, batch, mode):
    """Hidden state, loss (and its parts) and every gradient leaf; returns
    the port's loss, its gradients and the runtime that dispatched them."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = batch_to_tensors(batch, "cpu")
    with repro.runtime(mode=mode):
        jx, _, _ = jlm.forward(params, jb, jcfg, JRUN, mode="train")
        (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jb, jcfg, JRUN), has_aux=True))(params)
    leaves = adamw.leaves(tparams)
    for p in leaves:
        p.requires_grad_()
    with repro_torch.runtime(mode=mode) as rt:
        tx, _, _ = lm.forward(tparams, tb, cfg, RUN, mode="train")
        loss, aux = lm.loss_fn(tparams, tb, cfg, RUN)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _close(tx, jx, TOL)
    _close(loss, j_loss, TOL)
    _close(aux["xent"], j_aux["xent"], TOL)
    _close(aux["aux"], j_aux["aux"], TOL)
    names = [n for n, _ in adamw.named_leaves(tparams)]
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), cfg,
                                            device="cpu"))
    assert len(j_leaves) == len(grads) == len(names)
    for name, p, g, jg in zip(names, leaves, grads, j_leaves):
        # the token embedding of an arch fed by a frontend alone: JAX's
        # gradient is zeros, torch's is None
        g = torch.zeros_like(p) if g is None else g
        _close(g, jg.numpy(), TOL_ROUTER if name.endswith("router") else TOL_GRAD)
    return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)], rt


# Five archs here, the other five in test_torch_arch_smoke_more.py (a worker
# of their own), split so both files take about as long.
HERE = ("minitron_4b", "qwen2_5_3b", "qwen2_0_5b", "xlstm_1_3b", "musicgen_large")


@pytest.mark.parametrize("arch", HERE)
def test_forward_loss_and_gradients_match_jax(arch, rs):
    forward_loss_and_gradients_match_jax(arch, rs)


def forward_loss_and_gradients_match_jax(arch, rs):
    jcfg, cfg, params, tparams = _both(arch)
    assert sum(s.num_layers for s in cfg.segments()) == cfg.num_layers
    _, grads, _ = _against_jax(jcfg, cfg, params, tparams, make_batch(cfg, rs), "reference")
    # one AdamW step: the parameters change
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    state = adamw.init(opt, tparams)
    before = [p.detach().clone() for p in adamw.leaves(tparams)]
    with torch.no_grad():
        new, _, _ = adamw.update(opt, grads, state, tparams)
    diff = sum(float((a.detach().float() - b.float()).abs().sum())
               for a, b in zip(adamw.leaves(new), before))
    assert diff > 0, f"{arch}: optimizer step was a no-op"


def test_kernel_mode_at_paligemma_attention_geometry(rs):
    """Heads of 256 on one kv head, with the 4-patch prefix and its loss
    mask, through the dispatched kernels (the flash forward and backward at
    d = 256 among them) against JAX's Pallas kernels in interpret mode."""
    jcfg, cfg, params, tparams = _both("paligemma_3b", head_dim=256, num_kv_heads=1)
    assert cfg.hd == 256 and cfg.num_kv_heads == 1 and cfg.num_prefix == 4
    _, _, rt = _against_jax(jcfg, cfg, params, tparams, make_batch(cfg, rs), "kernel")
    snap = rt.telemetry.snapshot()
    keys = set(snap["by_key"])
    assert any(k.startswith("flash_attention|") and "x256/" in k for k in keys)
    assert any(k.startswith("flash_attention_bwd|") for k in snap["by_key_phase"]["bwd"])
    assert "reference" not in snap["tiers"]


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma3_27b", "mixtral_8x7b", "xlstm_1_3b",
                                  "jamba_1_5_large"])
def test_decode_matches_full_forward(arch, rs):
    """prefill + one decode step reproduce the full forward's next-token
    logits (gemma3's prompt runs past its reduced 8-token window, so its
    ring caches wrap)."""
    cfg = get_config(arch).reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S + 1))).long()
    with torch.inference_mode():
        x, _, _ = lm.forward(params, {"tokens": toks}, cfg, RUN, mode="train")
        full = unembed(params["lm_head"], x[:, -1])
        _, caches = lm.prefill(params, {"tokens": toks[:, :S]}, cfg, RUN, cache_len=S + 2)
        dec, _ = lm.decode_step(params, toks[:, S:], caches, torch.tensor(S), cfg, RUN)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=TOL_DECODE, atol=TOL_DECODE)


def test_gemma3_local_layers_have_windowed_cache():
    cfg = get_config("gemma3_27b")
    seg0 = tf.cache_shapes(cfg, batch=4, cache_len=32768)[0]     # 6-layer super-block x 10
    assert cfg.segments()[0].repeats == 10 and cfg.segments()[1].num_layers == 2
    for i in range(5):                       # five local layers: a 1024-row ring
        assert seg0[f"l{i}"]["k"][0] == (10, 4, 1024, 16, 128), i
    assert seg0["l5"]["k"][0] == (10, 4, 32768, 16, 128)          # the global layer
    tail = tf.cache_shapes(cfg, batch=4, cache_len=32768)[1]     # 2 trailing local layers
    assert all(tail[f"l{i}"]["v"][0][2] == 1024 for i in range(2))


def test_arctic_parallel_dense_moe():
    cfg = get_config("arctic_480b")
    assert {s.ffn for seg in cfg.segments() for s in seg.pattern} == {"moe+dense"}
    layer = lm.abstract_params(dataclasses.replace(cfg, num_layers=1))["segments"][0][0]["l0"]
    assert layer["moe"]["wg"].shape == (128, 7168, 4864) and "ffn" in layer


def test_param_counts_plausible():
    """The JAX test's ranges, counted on the meta device (nothing is
    allocated), and the same count as JAX's own for every arch."""
    expect = {
        "qwen2_0_5b": (0.4e9, 0.8e9),
        "minitron_4b": (4e9, 6.5e9),
        "mixtral_8x7b": (45e9, 50e9),
        "arctic_480b": (420e9, 520e9),
        "jamba_1_5_large": (330e9, 430e9),
        "gemma3_27b": (26e9, 32e9),
    }
    for arch, cfg in all_configs().items():
        n = lm.param_count(cfg)
        assert n == jlm.param_count(j_get_config(arch)), arch
        lo, hi = expect.get(arch, (0, float("inf")))
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.1f}B not in [{lo / 1e9},{hi / 1e9}]"


def test_xlstm_is_registered_with_its_2_9b_parameters():
    """The tenth arch, in the JAX registry's place, at 2.928 B parameters:
    24 mLSTM layers of 75.5 M, 24 sLSTM layers of 37.9 M, the embedding
    table and the untied unembed of 50,304 x 2,048 each."""
    from repro.configs.base import ARCH_NAMES as J_ARCH_NAMES

    assert ARCH_NAMES == J_ARCH_NAMES and len(ARCH_NAMES) == 10
    cfg = get_config("xlstm_1_3b")
    assert get_config("xlstm-1.3b") is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_get_config("xlstm_1_3b"))
    assert [(s.mixer, s.ffn) for s in cfg.segments()[0].pattern] == [("mlstm", "none"),
                                                                      ("slstm", "none")]
    block = lm.abstract_params(cfg)["segments"][0][0]
    per = {name: lm.param_count(block[name]) for name in ("l0", "l1")}
    assert per == {"l0": 75_536_392, "l1": 37_890_048}          # each with its norm
    assert lm.param_count(cfg) == 24 * (per["l0"] + per["l1"]) + 2 * 50_304 * 2_048 + 2_048
