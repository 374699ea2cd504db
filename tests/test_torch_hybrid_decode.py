"""The hybrid slice's decode: reduced Jamba-1.5-Large without experts (the
model of ``test_torch_hybrid.py``) in the port against the JAX package.

Held against JAX: three decode steps at a vector ``pos`` from a two-slot
pool, in kernel mode (JAX: Pallas in interpret mode; port: the kernels'
plain versions) and in reference mode; decode writes the Mamba state back
into the pool and dispatches every kernel on the path. Tolerance:
``test_torch_hybrid.py``'s. A file of its own, so that these cases and the
prefill cases run on two workers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_hybrid import (  # noqa: E402,F401
    CACHE_LEN,
    JRUN,
    RUN,
    _close,
    _prefill_both,
    model,
)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_three_decode_steps_at_vector_pos_match_jax(model, mode):
    """Two slots prefilled at different lengths, inserted into a pool, then
    three decode steps with pos = [L0 + t, L1 + t]: the logits and the pool's
    Mamba state after each step."""
    jcfg, cfg, params, tparams = model
    lens = (21, 8)
    j_pool = jlm.init_cache(jcfg, 2, CACHE_LEN)
    t_pool = lm.init_cache(cfg, 2, CACHE_LEN, "cpu")
    assert t_pool[0]["l1"]["h"].dtype == torch.float32
    for slot, L in enumerate(lens):
        toks = np.random.RandomState(L).randint(0, 256, (1, L)).astype(np.int32)
        (_, jc), (_, tc) = _prefill_both(model, mode, toks)
        j_pool = jlm.insert_cache(j_pool, jc, slot)
        lm.insert_cache(t_pool, tc, slot)
    rs = np.random.RandomState(9)
    for step in range(3):
        tokens = rs.randint(0, 256, (2, 1)).astype(np.int32)
        pos = np.array(lens, np.int32) + step
        with repro.runtime(mode=mode):
            jl, j_pool = jlm.decode_step(params, jnp.asarray(tokens), j_pool,
                                         jnp.asarray(pos), jcfg, JRUN)
        with repro_torch.runtime(mode=mode), torch.inference_mode():
            tl, t_pool = lm.decode_step(tparams, torch.from_numpy(tokens).long(), t_pool,
                                        torch.from_numpy(pos).long(), cfg, RUN)
        _close(tl, jl)
        for leaf in ("h", "conv"):
            _close(t_pool[0]["l3"][leaf], j_pool[0]["l3"][leaf])
        _close(t_pool[0]["l0"]["v"], j_pool[0]["l0"]["v"])


def test_decode_writes_the_mamba_state_back_into_the_pool(model):
    _, cfg, _, tparams = model
    pool = lm.init_cache(cfg, 2, CACHE_LEN, "cpu")
    before = {k: t.clone() for k, t in pool[0]["l2"].items()}
    with repro_torch.runtime(), torch.inference_mode():
        _, out = lm.decode_step(tparams, torch.tensor([[5], [6]]), pool, torch.tensor([0, 0]),
                                cfg, RUN)
    assert out is pool
    for k in ("h", "conv"):
        assert not torch.equal(pool[0]["l2"][k], before[k]), k


def test_decode_dispatches_every_kernel_on_the_path(model):
    _, cfg, _, tparams = model
    toks = torch.from_numpy(np.arange(13)[None]).long()
    with repro_torch.runtime() as rt, torch.inference_mode():
        _, caches = lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
        lm.decode_step(tparams, toks[:, :1], caches, torch.tensor([13]), cfg, RUN)
    kernels = {k.split("|")[0] for k in rt.telemetry.by_key}
    assert kernels == {"matmul", "rmsnorm", "flash_attention", "ssm_scan", "ssm_update"}
    assert set(rt.telemetry.tiers) == {"heuristic"}
