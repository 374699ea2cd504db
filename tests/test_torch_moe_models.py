"""The MoE slice's models in the port against the JAX package, on the CPU
(the kernel and the MoE layer: ``test_torch_moe.py``).

* Reduced Mixtral-8x7B (2 layers, 4 experts top-2, window 8, f32):
  prefill logits, ``loss_fn`` (xent and aux) and every gradient leaf;
  reduced Jamba-1.5-Large with its MoE layers: prefill. Parameters are
  carried across by ``from_jax_params``; tolerance 1e-5 of max (1e-4 for
  the gradients of the router, whose softmax sums over few experts).

Their decode: ``test_torch_moe_decode.py``; their serving engines:
``test_torch_moe_serving.py``.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import batch_to_tensors, from_jax_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

JRUN = JRun(remat="none", q_chunk=16, k_chunk=16, loss_chunk=32)
RUN = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=32)
CACHE_LEN = 48
TOL = 1e-5


def _close(t, j, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max() if t.size else 0.0
    assert err <= tol * max(np.abs(j).max() if j.size else 0.0, 1e-6), err


# ---------------------------------------------------------------------------
# Reduced Mixtral-8x7B and reduced Jamba-1.5-Large with experts
# ---------------------------------------------------------------------------


def _model(name, **over):
    jcfg = dataclasses.replace(j_get_config(name).reduced(), **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, tparams


@pytest.fixture(scope="module")
def mixtral():
    return _model("mixtral_8x7b")


@pytest.fixture(scope="module")
def jamba():
    return _model("jamba_1_5_large")


def test_configs_are_the_jax_ones():
    for name in ("mixtral_8x7b", "jamba_1_5_large"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
    assert get_config("mixtral-8x7b") is get_config("mixtral_8x7b")
    cfg = get_config("mixtral_8x7b")
    assert [(s.mixer, s.window, s.ffn) for s in cfg.segments()[0].pattern] == \
        [("attn", 4096, "moe")]
    jam = [(s.mixer, s.ffn) for s in get_config("jamba_1_5_large").segments()[0].pattern]
    assert jam == [("attn", "dense"), ("mamba", "moe")] + [("mamba", "dense"), ("mamba", "moe")] * 3


@pytest.mark.parametrize("name", ["mixtral_8x7b", "jamba_1_5_large"])
def test_own_init_has_the_jax_leaves(request, name):
    # the module's model: JAX's init of the reduced config, converted
    _, cfg, _, conv = request.getfixturevalue(name.split("_")[0])
    own = lm.init_params(cfg, 0, "cpu")
    shapes = lambda p: [(tuple(t.shape), t.dtype) for t in adamw.leaves(p)]
    assert shapes(own) == shapes(conv)
    ffn = own["segments"][0][0]["l1" if name == "jamba_1_5_large" else "l0"]["moe"]
    assert set(ffn) == {"router", "wg", "wu", "wd"} and ffn["router"].dtype == torch.float32
    # the JAX scale: 1/sqrt of the expert count for an [e, d, ff] stack
    assert abs(float(ffn["wg"].std()) - 0.5) < 0.05


def _prefill_both(model, mode, toks, true_len=None, jmode=None):
    jcfg, cfg, params, tparams = model
    L = toks.shape[1] if true_len is None else true_len
    with repro.runtime(mode=jmode or mode):
        jl, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, JRUN,
                             cache_len=CACHE_LEN, true_len=jnp.asarray(L))
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        tl, tc = lm.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, cfg, RUN,
                            cache_len=CACHE_LEN, true_len=L)
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
@pytest.mark.parametrize("length,bucket", [(5, 5), (13, 16), (21, 32)])
def test_mixtral_prefill_matches_jax(mixtral, mode, length, bucket):
    """Right-padded buckets, as the engine prefills: pads take no capacity
    and the window cache ring-aligns to the real length."""
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :length] = np.random.RandomState(length).randint(0, 256, length)
    (jl, jc), (tl, tc) = _prefill_both(mixtral, mode, toks, length)
    _close(tl, jl)
    _close(tc[0]["l0"]["k"], jc[0]["l0"]["k"])
    assert tc[0]["l0"]["k"].shape[2] == 8          # the window's rolling cache


def _decode_both(model, mode, lens, steps=3, jmode=None):
    jcfg, cfg, params, tparams = model
    j_pool = jlm.init_cache(jcfg, len(lens), CACHE_LEN)
    t_pool = lm.init_cache(cfg, len(lens), CACHE_LEN, "cpu")
    for slot, L in enumerate(lens):
        toks = np.random.RandomState(L).randint(0, 256, (1, L)).astype(np.int32)
        (_, jc), (_, tc) = _prefill_both(model, mode, toks, jmode=jmode)
        j_pool = jlm.insert_cache(j_pool, jc, slot)
        lm.insert_cache(t_pool, tc, slot)
    rs = np.random.RandomState(9)
    for step in range(steps):
        tokens = rs.randint(0, 256, (len(lens), 1)).astype(np.int32)
        pos = np.array(lens, np.int32) + step
        with repro.runtime(mode=jmode or mode):
            jl, j_pool = jlm.decode_step(params, jnp.asarray(tokens), j_pool,
                                         jnp.asarray(pos), jcfg, JRUN)
        with repro_torch.runtime(mode=mode), torch.inference_mode():
            tl, t_pool = lm.decode_step(tparams, torch.from_numpy(tokens).long(), t_pool,
                                        torch.from_numpy(pos).long(), cfg, RUN)
        _close(tl, jl)
    return j_pool, t_pool


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_mixtral_loss_and_every_gradient_leaf_match_jax(mixtral, mode):
    jcfg, cfg, params, tparams = mixtral
    batch = JPipe(jcfg, JData(seed=1, batch_size=2, seq_len=24)).next_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with repro.runtime(mode=mode):
        (j_loss, j_aux), j_grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jb, jcfg, JRUN), has_aux=True)(params)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_()
    with repro_torch.runtime(mode=mode) as rt:
        loss, aux = lm.loss_fn(tp, batch_to_tensors(batch, "cpu"), cfg, RUN)
        grads = torch.autograd.grad(loss, leaves)
    _close(loss, j_loss)
    _close(aux["xent"], j_aux["xent"])
    _close(aux["aux"], j_aux["aux"])
    assert float(aux["aux"].detach()) > 0.5          # two layers of e * sum(me * ce), about 1 each
    names = [n for n, _ in adamw.named_leaves(tp)]
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), cfg,
                                            device="cpu"))
    assert len(j_leaves) == len(grads) == len(names)
    for name, g, jg in zip(names, grads, j_leaves):
        _close(g, jg.numpy(), 1e-4 if name.endswith("router") else TOL)
    if mode == "kernel":
        kernels = {k.split("|")[0] for k in rt.telemetry.snapshot()["by_key_phase"]["bwd"]}
        assert "expert_gemm" in kernels


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_jamba_with_experts_prefill_matches_jax(jamba, mode):
    toks = np.random.RandomState(19).randint(0, 256, (1, 19)).astype(np.int32)
    (jl, jc), (tl, tc) = _prefill_both(jamba, mode, toks)
    _close(tl, jl)
    for leaf in ("h", "conv"):
        _close(tc[0]["l3"][leaf], jc[0]["l3"][leaf])


def test_prefill_dispatches_expert_gemm_three_times_a_layer(mixtral):
    _, cfg, _, tparams = mixtral
    toks = torch.from_numpy(np.arange(13)[None]).long()
    with repro_torch.runtime() as rt, torch.inference_mode():
        lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
    calls = {k: v for k, v in rt.telemetry.by_key.items() if k.startswith("expert_gemm")}
    assert sum(sum(t.values()) for t in calls.values()) == 3 * cfg.num_layers
    assert {k.split("|")[0] for k in rt.telemetry.by_key} == \
        {"matmul", "rmsnorm", "flash_attention", "expert_gemm"}
