"""The port's model against the JAX package's, at reduced qwen2_0_5b (f32).

The JAX ``init_params`` output crosses through numpy with
``from_jax_params``; prefill (exact and bucketed with ``true_len``) and a
vector-``pos`` decode step must give the JAX logits and caches, in kernel
mode (JAX: Pallas in interpret mode; port: each kernel's plain version)
and in reference mode.

Tolerance: 1e-5 of max|logit| — the same fp32 math through two layers,
with sums taken in another order.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402

JRUN = JRun(remat="none", q_chunk=16, k_chunk=16)
RUN = RunConfig(q_chunk=16, k_chunk=16)
CACHE_LEN = 48
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("qwen2_0_5b").reduced()
    cfg = get_config("qwen2_0_5b").reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _close(t, j):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= TOL * max(np.abs(j).max(), 1.0)


def _prefill_both(model, mode, toks, true_len):
    jcfg, cfg, params, tparams = model
    with repro.runtime(mode=mode):
        jl, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, JRUN,
                             cache_len=CACHE_LEN,
                             true_len=None if true_len is None else jnp.asarray(true_len))
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        tl, tc = lm.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, cfg, RUN,
                            cache_len=CACHE_LEN, true_len=true_len)
    return (jl, jc), (tl, tc)


def test_converted_params_keep_every_leaf(model):
    jcfg, cfg, params, tparams = model
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert lm.param_count(tparams) == n_jax
    assert len(tparams["segments"][0]) == cfg.num_layers
    np.testing.assert_array_equal(
        tparams["segments"][0][1]["l0"]["mixer"]["q"]["w"].numpy(),
        np.asarray(params["segments"][0]["l0"]["mixer"]["q"]["w"][1]))


@pytest.mark.parametrize("mode", ["kernel", "reference"])
@pytest.mark.parametrize("seq,true_len", [(19, None), (32, 21)])
def test_prefill_matches_jax(model, mode, seq, true_len):
    toks = np.random.RandomState(seq).randint(0, 256, (1, seq)).astype(np.int32)
    (jl, jc), (tl, tc) = _prefill_both(model, mode, toks, true_len)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[0]["l0"][name], jc[0]["l0"][name])


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_decode_at_vector_pos_matches_jax(model, mode):
    """Two slots at different positions: prefill each (bucketed), insert
    into a pool, and decode one step with pos = [L0, L1]."""
    jcfg, cfg, params, tparams = model
    lens = (21, 9)
    j_pool = jlm.init_cache(jcfg, 2, CACHE_LEN)
    t_pool = lm.init_cache(cfg, 2, CACHE_LEN, "cpu")
    for slot, L in enumerate(lens):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :L] = np.random.RandomState(L).randint(0, 256, L)
        (_, jc), (_, tc) = _prefill_both(model, mode, toks, L)
        j_pool = jlm.insert_cache(j_pool, jc, slot)
        lm.insert_cache(t_pool, tc, slot)
    tokens = np.array([[7], [200]], np.int32)
    pos = np.array(lens, np.int32)
    with repro.runtime(mode=mode):
        jl, j_new = jlm.decode_step(params, jnp.asarray(tokens), j_pool, jnp.asarray(pos),
                                    jcfg, JRUN)
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        tl, t_new = lm.decode_step(tparams, torch.from_numpy(tokens).long(), t_pool,
                                   torch.from_numpy(pos).long(), cfg, RUN)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(t_new[0]["l0"][name], j_new[0]["l0"][name])


def test_decode_dispatches_every_kernel_on_the_path(model):
    jcfg, cfg, params, tparams = model
    toks = torch.from_numpy(np.arange(16)[None]).long()
    with repro_torch.runtime() as rt, torch.inference_mode():
        _, caches = lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
        lm.decode_step(tparams, toks[:, :1], caches, torch.tensor([16]), cfg, RUN)
    kernels = {k.split("|")[0] for k in rt.telemetry.by_key}
    assert kernels == {"matmul", "rmsnorm", "flash_attention"}
    assert set(rt.telemetry.tiers) == {"heuristic"}


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_sliding_window_attention_layer_matches_jax(model, mode):
    """The window paths qwen2_0_5b does not take: flash with a window at
    prefill, the ring-aligned window cache from a bucketed prompt, and the
    rolling-cache decode."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jcfg, cfg, params, tparams = model
    jp = jax.tree_util.tree_map(lambda a: a[0], params["segments"][0]["l0"]["mixer"])
    tp = tparams["segments"][0][0]["l0"]["mixer"]
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.hd,
              rope_theta=cfg.rope_theta, window=8)
    x = np.random.RandomState(1).randn(1, 32, cfg.d_model).astype(np.float32)
    with repro.runtime(mode=mode):
        jy, jc = jattn.attention_forward(jp, jnp.asarray(x), q_chunk=16, k_chunk=16,
                                         return_cache=True, cache_len=CACHE_LEN,
                                         true_len=jnp.asarray(21), **kw)
        jd, jc2 = jattn.attention_decode(jp, jnp.asarray(x[:, :1]), jc,
                                         jnp.asarray([21]), **kw)
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        ty, tc = tattn.attention_forward(tp, torch.from_numpy(x), q_chunk=16, k_chunk=16,
                                         return_cache=True, cache_len=CACHE_LEN,
                                         true_len=21, **kw)
        _close(tc["k"], jc["k"])
        td, tc2 = tattn.attention_decode(tp, torch.from_numpy(x[:, :1]), tc,
                                         torch.tensor([21]), **kw)
    _close(ty, jy)
    _close(td, jd)
    _close(tc2["v"], jc2["v"])
