"""Each kernel module of the port against the JAX package, on the CPU.

The same numpy inputs go through the JAX Pallas kernel in interpret mode
and through the port's plain version of its CUDA kernel (what the port's
wrapper runs on a CPU tensor), in f32 and bf16; the reference tiers of both
packages are compared too.

Tolerances, relative to max|JAX output|: f32 1e-5 (the same fp32 math, sums
in another order); bf16 2e-2 (inputs rounded identically, then fp32 math
and one bf16 rounding of the output, 2^-8, on each side, plus bf16
intermediates where the reference rounds before its last multiply).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.attention import flash_attention_pallas  # noqa: E402
from repro.kernels.matmul import matmul_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro_torch.core.runtime import dispatch  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(t_out, j_out, dtype):
    j = np.asarray(jnp.asarray(j_out).astype(jnp.float32))
    t = t_out.float().numpy()
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= DTYPES[dtype][2] * max(np.abs(j).max(), 1e-6), err


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n,blocks", [
    (32, 64, 16, (8, 128, 128)),
    (37, 100, 45, (16, 128, 128)),     # nothing divides: the Pallas kernel pads
    (8, 896, 130, (8, 128, 256)),
])
def test_matmul_matches_pallas(dtype, m, k, n, blocks):
    rs = np.random.RandomState(m * k + n)
    jx, tx = _pair(rs.randn(m, k).astype(np.float32), dtype)
    jw, tw = _pair((rs.randn(k, n) / np.sqrt(k)).astype(np.float32), dtype)
    bm, bn, bk = blocks
    j_out = matmul_pallas(jx, jw, bm=bm, bn=bn, bk=bk, interpret=True)
    _close(mm.matmul_plain(tx, tw), j_out, dtype)
    _close(dispatch("matmul", tx, tw), j_out, dtype)        # CPU tensor: plain version
    _close(tref.matmul(tx, tw), jref.matmul(jx, jw), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,block_rows", [(16, 64, 8), (13, 100, 8), (8, 896, 4)])
def test_rmsnorm_matches_pallas(dtype, rows, d, block_rows):
    rs = np.random.RandomState(rows + d)
    jx, tx = _pair(rs.randn(rows, d).astype(np.float32), dtype)
    jw, tw = _pair((1 + 0.1 * rs.randn(d)).astype(np.float32), dtype)
    j_out, j_r = rmsnorm_pallas(jx, jw, block_rows=block_rows, eps=1e-6, interpret=True,
                                return_residuals=True)
    t_out, t_r = rn.rmsnorm_plain(tx, tw, 1e-6)
    _close(t_out, j_out, dtype)
    _close(t_r, j_r, "float32")          # inverse rms is fp32 on both sides
    _close(dispatch("rmsnorm", tx, tw, eps=1e-6), j_out, dtype)
    j_ref, j_ref_r = jref.rmsnorm_res(jx, jw, 1e-6)
    t_ref, t_ref_r = tref.rmsnorm_res(tx, tw, 1e-6)
    _close(t_ref, j_ref, dtype)
    _close(t_ref_r, j_ref_r, "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s_q,s_k,window,blocks", [
    (64, 64, 0, (32, 32)),            # causal, several q and k tiles
    (64, 64, 24, (32, 16)),           # sliding window: dead tiles before the window
    (32, 64, 0, (16, 32)),            # s_q < s_k: q aligned to the end of k
])
def test_flash_attention_matches_pallas(dtype, s_q, s_k, window, blocks):
    rs = np.random.RandomState(s_q + s_k + window)
    d = 16
    jq, tq = _pair((rs.randn(1, 4, s_q, d) * 0.5).astype(np.float32), dtype)
    jk, tk = _pair((rs.randn(1, 2, s_k, d) * 0.5).astype(np.float32), dtype)   # GQA 4:2
    jv, tv = _pair(rs.randn(1, 2, s_k, d).astype(np.float32), dtype)
    bq, bk = blocks
    j_out, j_lse = flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk, causal=True,
                                          window=window, interpret=True, return_residuals=True)
    t_out, t_lse = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    _close(t_out, j_out, dtype)
    _close(t_lse, j_lse, "float32")
    _close(dispatch("flash_attention", tq, tk, tv, causal=True, window=window), j_out, dtype)
    _close(tref.attention(tq, tk, tv, causal=True, window=window),
           jref.attention(jq, jk, jv, causal=True, window=window), dtype)


def test_plain_rmsnorm_follows_the_kernel_not_the_reference():
    """The kernel multiplies by the weight in fp32 before its cast; the
    reference casts first. In bf16 the two differ; the plain version must
    agree with the TPU kernel bit for bit on these inputs."""
    rs = np.random.RandomState(3)
    jx, tx = _pair(rs.randn(64, 96).astype(np.float32), "bfloat16")
    jw, tw = _pair((1 + 0.3 * rs.randn(96)).astype(np.float32), "bfloat16")
    j_out = rmsnorm_pallas(jx, jw, block_rows=16, interpret=True)
    t_out, _ = rn.rmsnorm_plain(tx, tw)
    same = np.asarray(jnp.asarray(j_out).astype(jnp.float32)) == t_out.float().numpy()
    assert same.mean() > 0.99
    assert not torch.equal(t_out, tref.rmsnorm(tx, tw))
