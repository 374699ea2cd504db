"""Flash attention at head dim 256 (PaliGemma's heads) against the JAX
package, on the CPU.

The TPU kernels take any head dim. The same numpy inputs go through
``flash_attention_pallas`` and ``flash_attention_bwd_pallas`` in interpret
mode and through the port's plain forward and backward (what the wrappers
run on a CPU tensor, and what the card's kernels are held to): causal and
windowed, a group of 8 q heads on one kv head (MQA) and MHA, s_q = s_k and
s_q < s_k, in f32 and bf16; the dispatched call and the reference tiers of
both packages too.

Tolerances, relative to max|JAX output| (lse: fp32 on both sides), as in
``test_torch_kernels.py``: f32 1e-5 (the same fp32 math, sums over 256
products in another order); bf16 2e-2 (inputs rounded alike, fp32 math and
one bf16 rounding of each output on each side).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.attention import flash_attention_bwd_pallas  # noqa: E402
from repro.kernels.attention import flash_attention_pallas  # noqa: E402
from repro_torch.core.runtime import dispatch  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

D = 256
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# (h, kv, s_q, s_k, window, (block_q, block_k) of the Pallas kernel)
CASES = [
    (8, 1, 64, 64, 0, (32, 32)),        # MQA group of 8, causal
    (8, 1, 64, 64, 24, (32, 16)),       # MQA, sliding window: dead tiles before it
    (2, 2, 32, 64, 0, (16, 32)),        # MHA, s_q < s_k: q aligned to the end of k
    (2, 2, 48, 48, 16, (16, 16)),       # MHA, windowed
]


def _pair(x, dtype):
    jd, td, _ = DTYPES[dtype]
    j = jnp.asarray(x).astype(jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def _close(t, j, dtype):
    tol = DTYPES[dtype][2]
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.float().numpy()
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= tol * max(np.abs(j).max(), 1e-6), err


def _inputs(rs, h, kv, s_q, s_k, dtype):
    jq, tq = _pair((rs.randn(1, h, s_q, D) * 0.3).astype(np.float32), dtype)
    jk, tk = _pair((rs.randn(1, kv, s_k, D) * 0.3).astype(np.float32), dtype)
    jv, tv = _pair(rs.randn(1, kv, s_k, D).astype(np.float32), dtype)
    jdo, tdo = _pair(rs.randn(1, h, s_q, D).astype(np.float32), dtype)
    return (jq, jk, jv, jdo), (tq, tk, tv, tdo)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,kv,s_q,s_k,window,blocks", CASES)
def test_flash_forward_at_d256_matches_pallas(dtype, h, kv, s_q, s_k, window, blocks):
    rs = np.random.RandomState(h + s_q + s_k + window)
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(rs, h, kv, s_q, s_k, dtype)
    bq, bk = blocks
    j_out, j_lse = flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk, causal=True,
                                          window=window, interpret=True, return_residuals=True)
    t_out, t_lse = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    _close(t_out, j_out, dtype)
    _close(t_lse, j_lse, "float32")
    _close(dispatch("flash_attention", tq, tk, tv, causal=True, window=window), j_out, dtype)
    _close(tref.attention(tq, tk, tv, causal=True, window=window),
           jref.attention(jq, jk, jv, causal=True, window=window), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,kv,s_q,s_k,window,blocks", CASES)
def test_flash_backward_at_d256_matches_pallas(dtype, h, kv, s_q, s_k, window, blocks):
    rs = np.random.RandomState(7 * h + s_q + s_k + window)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(rs, h, kv, s_q, s_k, dtype)
    bq, bk = blocks
    kw = dict(causal=True, window=window)
    j_o, j_lse = flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk, interpret=True,
                                        return_residuals=True, **kw)
    t_o, t_lse = fa.flash_attention_plain(tq, tk, tv, **kw)
    j_grads = flash_attention_bwd_pallas(jdo, jq, jk, jv, j_o, j_lse, block_q=bq, block_k=bk,
                                         interpret=True, **kw)
    t_grads = fa.flash_attention_bwd_plain(tdo, tq, tk, tv, t_o, t_lse, **kw)
    d_grads = dispatch("flash_attention_bwd", tdo, tq, tk, tv, t_o, t_lse, **kw)
    r_grads = tref.attention_bwd(tdo, tq, tk, tv, **kw)
    jr_grads = jref.attention_bwd(jdo, jq, jk, jv, **kw)
    for t, dd, j, tr, jr in zip(t_grads, d_grads, j_grads, r_grads, jr_grads):
        assert t.shape[-1] == D
        _close(t, j, dtype)
        _close(dd, j, dtype)
        _close(tr, jr, dtype)
