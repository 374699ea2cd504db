"""The hybrid slice: reduced Jamba-1.5-Large without experts (1 attention
+ 7 Mamba layers a super-block, dense SwiGLU FFNs, f32, 16 layers) in the
port against the JAX package.

The JAX ``init_params`` output crosses through numpy with
``from_jax_params``. Held against JAX: every parameter leaf with its dtype;
prefill logits and caches at exact prompt lengths (an SSM arch prefills at
exact length), in kernel mode (JAX: Pallas in interpret mode; port: the
kernels' plain versions) and in reference mode. Three decode steps at a
vector ``pos`` from a two-slot pool are held in
``test_torch_hybrid_decode.py``; the converted parameters, the serving
engine's tokens and the serving plan in ``test_torch_hybrid_serving.py``:
each runs on a worker of its own.

Tolerance: 1e-5 of max|logit| (at least 1), as for the dense model: the
same fp32 math through 16 layers, with sums taken in another order.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402

JRUN = JRun(remat="none", q_chunk=16, k_chunk=16)
RUN = RunConfig(q_chunk=16, k_chunk=16)
CACHE_LEN = 48
TOL = 1e-5
DENSE = dict(num_experts=0, experts_per_token=0)


def _dense(get, reduced=True):
    cfg = dataclasses.replace(get("jamba_1_5_large"), **DENSE)
    return cfg.reduced() if reduced else cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _dense(j_get_config), _dense(get_config)
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _close(t, j):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= TOL * max(np.abs(j).max(), 1.0), np.abs(t - j).max()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def test_the_config_is_the_jax_one():
    jcfg, cfg = _dense(j_get_config, False), _dense(get_config, False)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert [(s.mixer, s.ffn) for s in cfg.segments()[0].pattern] == \
        [("attn", "dense")] + [("mamba", "dense")] * 7
    assert get_config("jamba-1.5-large-398b") is get_config("jamba_1_5_large")


_JAX_PREFILL = {}


def _prefill_both(model, mode, toks):
    """Both packages' prefill of ``toks``; JAX's once a (mode, prompt) in a
    process."""
    jcfg, cfg, params, tparams = model
    L = toks.shape[1]
    key = (mode, toks.tobytes())
    if key not in _JAX_PREFILL:
        with repro.runtime(mode=mode):
            _JAX_PREFILL[key] = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, JRUN,
                                            cache_len=CACHE_LEN, true_len=jnp.asarray(L))
    jl, jc = _JAX_PREFILL[key]
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        tl, tc = lm.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, cfg, RUN,
                            cache_len=CACHE_LEN, true_len=L)
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
@pytest.mark.parametrize("length", [2, 8, 19, 37])
def test_prefill_matches_jax(model, mode, length):
    toks = np.random.RandomState(length).randint(0, 256, (1, length)).astype(np.int32)
    (jl, jc), (tl, tc) = _prefill_both(model, mode, toks)
    _close(tl, jl)
    _close(tc[0]["l0"]["k"], jc[0]["l0"]["k"])
    for i in (1, 7):
        for leaf in ("h", "conv"):
            _close(tc[0][f"l{i}"][leaf], jc[0][f"l{i}"][leaf])
    assert tc[0]["l1"]["h"].dtype == torch.float32
