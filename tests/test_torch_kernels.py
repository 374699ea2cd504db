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


# ---------------------------------------------------------------------------
# Training kernels: the backward plane and the cross entropy
# ---------------------------------------------------------------------------

from repro.kernels.attention import flash_attention_bwd_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_bwd_pallas  # noqa: E402
from repro.kernels.xent import softmax_xent_bwd_pallas, softmax_xent_pallas  # noqa: E402
from repro_torch.kernels import xent as xe  # noqa: E402


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n,ta,tb", [
    (24, 40, 56, False, True),         # ct @ w^T
    (40, 24, 56, True, False),         # x^T @ ct
    (37, 100, 45, True, True),         # ragged, both transposed
])
def test_matmul_plain_reads_transposed_operands(dtype, m, k, n, ta, tb):
    """The backward's operands reach the wrapper as transposed views, which
    the kernel reads in place; on the CPU the plain version takes them as
    they are. The JAX kernel gets the same values, materialized."""
    rs = np.random.RandomState(m + k + n)
    a = rs.randn(m, k).astype(np.float32)
    b = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    jx, tx = _pair(np.ascontiguousarray(a.T) if ta else a, dtype)
    jw, tw = _pair(np.ascontiguousarray(b.T) if tb else b, dtype)
    tx, tw = (tx.T if ta else tx), (tw.T if tb else tw)
    jx, jw = (jx.T if ta else jx), (jw.T if tb else jw)
    assert mm.layout(tx) == (ta, m if ta else k) and mm.layout(tw) == (tb, k if tb else n)
    j_out = matmul_pallas(jx, jw, bm=8, bn=128, bk=128, interpret=True)
    _close(mm.matmul_plain(tx, tw), j_out, dtype)
    _close(dispatch("matmul", tx, tw), j_out, dtype)


def test_matmul_layout_refuses_other_strides():
    with pytest.raises(ValueError, match="row-major or transposed"):
        mm.layout(torch.zeros(8, 16)[:, ::2])
    assert mm.layout(torch.zeros(3, 5, 16)[:, -1]) == (False, 80)    # a row stride


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,block_rows", [(16, 64, 8), (13, 100, 8)])
def test_rmsnorm_bwd_matches_pallas(dtype, rows, d, block_rows):
    rs = np.random.RandomState(rows * d)
    jx, tx = _pair(rs.randn(rows, d).astype(np.float32), dtype)
    jw, tw = _pair((1 + 0.1 * rs.randn(d)).astype(np.float32), dtype)
    jct, tct = _pair(rs.randn(rows, d).astype(np.float32), dtype)
    _, j_r = rmsnorm_pallas(jx, jw, block_rows=block_rows, interpret=True,
                            return_residuals=True)
    _, t_r = rn.rmsnorm_plain(tx, tw)
    j_dx, j_dw = rmsnorm_bwd_pallas(jct, jx, jw, j_r, block_rows=block_rows, interpret=True)
    t_dx, t_dw = rn.rmsnorm_bwd_plain(tct, tx, tw, t_r)
    _close(t_dx, j_dx, dtype)
    _close(t_dw, j_dw, dtype)
    _close(dispatch("rmsnorm_bwd", tct, tx, tw, t_r)[0], j_dx, dtype)
    # the oracles: the VJP of the forward oracle in both packages
    j_ref = jref.rmsnorm_bwd(jct, jx, jw)
    for t, j in zip(tref.rmsnorm_bwd(tct, tx, tw), j_ref):
        _close(t, j, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,vocab,blocks", [
    (16, 640, (8, 512)),
    (13, 1000, (8, 512)),             # ragged rows and vocab: the Pallas kernel pads
])
def test_softmax_xent_matches_pallas(dtype, rows, vocab, blocks):
    rs = np.random.RandomState(rows + vocab)
    jl, tl = _pair((rs.randn(rows, vocab) * 2).astype(np.float32), dtype)
    labels = rs.randint(0, vocab, rows).astype(np.int32)
    jlab, tlab = jnp.asarray(labels), torch.from_numpy(labels)
    br, bv = blocks
    j_loss, j_lse = softmax_xent_pallas(jl, jlab, block_rows=br, block_v=bv, interpret=True,
                                        return_residuals=True)
    t_loss, t_lse = xe.softmax_xent_plain(tl, tlab)
    # loss and lse are fp32 on both sides, from the same rounded logits
    _close(t_loss, j_loss, "float32")
    _close(t_lse, j_lse, "float32")
    _close(dispatch("softmax_xent", tl, tlab), j_loss, "float32")
    _close(tref.softmax_xent(tl, tlab), jref.softmax_xent(jl, jlab), "float32")
    ct = rs.randn(rows).astype(np.float32)
    j_dl = softmax_xent_bwd_pallas(jnp.asarray(ct), jl, jlab, j_lse, block_rows=br,
                                   block_v=bv, interpret=True)
    t_dl = xe.softmax_xent_bwd_plain(torch.from_numpy(ct), tl, tlab, t_lse)
    _close(t_dl, j_dl, dtype)
    _close(tref.softmax_xent_bwd(torch.from_numpy(ct), tl, tlab),
           jref.softmax_xent_bwd(jnp.asarray(ct), jl, jlab), dtype)


def test_softmax_xent_plain_gives_a_label_off_the_row_no_logit():
    """As the TPU kernel: a label outside [0, vocab) never hits, so the loss
    is the lse alone (the reference would index out of range)."""
    logits = torch.randn(3, 10)
    loss, lse = xe.softmax_xent_plain(logits, torch.tensor([2, -1, 10]))
    assert torch.equal(loss[1:], lse[1:]) and not torch.equal(loss[0], lse[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s_q,s_k,window,blocks", [
    (64, 64, 0, (32, 32)),            # causal, several q and k tiles
    (64, 64, 24, (32, 16)),           # sliding window: dead tiles on both sides
    (32, 64, 0, (16, 32)),            # s_q < s_k: q aligned to the end of k
])
def test_flash_attention_bwd_matches_pallas(dtype, s_q, s_k, window, blocks):
    rs = np.random.RandomState(7 * s_q + s_k + window)
    d = 16
    jq, tq = _pair((rs.randn(1, 4, s_q, d) * 0.5).astype(np.float32), dtype)
    jk, tk = _pair((rs.randn(1, 2, s_k, d) * 0.5).astype(np.float32), dtype)   # GQA 4:2
    jv, tv = _pair(rs.randn(1, 2, s_k, d).astype(np.float32), dtype)
    jdo, tdo = _pair(rs.randn(1, 4, s_q, d).astype(np.float32), dtype)
    bq, bk = blocks
    j_o, j_lse = flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk, causal=True,
                                        window=window, interpret=True, return_residuals=True)
    t_o, t_lse = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    j_grads = flash_attention_bwd_pallas(jdo, jq, jk, jv, j_o, j_lse, block_q=bq, block_k=bk,
                                         causal=True, window=window, interpret=True)
    t_grads = fa.flash_attention_bwd_plain(tdo, tq, tk, tv, t_o, t_lse, causal=True,
                                           window=window)
    kw = dict(causal=True, window=window)
    d_grads = dispatch("flash_attention_bwd", tdo, tq, tk, tv, t_o, t_lse, **kw)
    r_grads = tref.attention_bwd(tdo, tq, tk, tv, **kw)
    jr_grads = jref.attention_bwd(jdo, jq, jk, jv, **kw)
    for t, dd, j, tr, jr in zip(t_grads, d_grads, j_grads, r_grads, jr_grads):
        _close(t, j, dtype)
        _close(dd, j, dtype)
        _close(tr, jr, dtype)
