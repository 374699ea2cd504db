"""The selective scan's backward and the model-level tunables in the port
against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and go through both packages:

* ``ssm_scan_bwd`` (the port's chunk-windowed adjoint recurrence) against
  the JAX tunable (the VJP of its chunked associative-scan form) and both
  packages' oracles (the autograd VJPs of the sequential scans), at chunks
  8, 16 and 64 with s = 37 (a multiple of none), xc in f32 and bf16, a
  nonzero carry-in and a live cotangent on the final state;
* ``ssm_update_bwd`` at block_d 8 (two strips of a 12-wide d_inner, d_B
  and d_C summed across them) and 12 (one strip);
* the kernel-mode gradients of ``dispatch("ssm_scan")`` and
  ``dispatch("ssm_update")`` (port: the kernels' plain versions, the
  backward plans dispatching ``ssm_scan_bwd`` / ``ssm_update_bwd``) against
  ``jax.vjp`` of the JAX dispatch (Pallas in interpret mode), with the same
  backward keys;
* ``attn_chunks``, ``mamba_chunk`` and ``xent_chunk`` against
  ``repro.models.tunables`` at several chunks, and invariant to the chunk.

Tolerance: 1e-5 of max|JAX| (at least 1e-6); 2^-8 for xc's gradient where
xc is bf16, which JAX returns in bf16. Both sides compute in fp32
with the same recurrence; the port walks the state's cotangent backwards
step by step where JAX differentiates an associative scan, and d_A sums
b * s terms, so sums run in another order: about 1e-7 relative here.
The chunked attention and the chunked loss: 1e-5 as well (one fp32
softmax or logsumexp in another chunking).
"""
import contextlib
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import annotate as jannotate  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import tunables as jtun  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.core import annotate  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import tunables  # noqa: E402

jss = importlib.import_module("repro.kernels.ssm_scan")

TOL = 1e-5


def _close(t, j, floor=1e-6, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    assert np.abs(t - j).max() <= tol * max(np.abs(j).max(), floor), np.abs(t - j).max()


def _tol(i, xdtype):
    """xc's gradient is bf16 where xc is (a VJP returns its primal's dtype),
    so the two sides may round it one bf16 step apart: 2^-8 of max."""
    return 2.0 ** -8 if i == 0 and xdtype == "bfloat16" else TOL


def _inputs(seed, lead, di, ds, xdtype):
    """numpy inputs in the mixer's ranges (dt > 0, A < 0, a nonzero carry)
    and the two cotangents, xc cast to ``xdtype`` on both sides."""
    rs = np.random.RandomState(seed)
    f = np.float32
    xc = (rs.randn(*lead, di) * 0.5).astype(f)
    if xdtype == "bfloat16":             # values bf16 can hold, on both sides
        xc = np.asarray(jnp.asarray(xc, jnp.bfloat16).astype(jnp.float32))
    args = (xc, (np.abs(rs.randn(*lead, di)) * 0.1 + 0.01).astype(f),
            (rs.randn(*lead, ds) * 0.5).astype(f), (rs.randn(*lead, ds) * 0.5).astype(f),
            (-np.abs(rs.randn(di, ds)) - 0.1).astype(f),
            (rs.randn(lead[0], di, ds) * 0.3).astype(f))
    cts = ((rs.randn(*lead, di) * 0.5).astype(f), (rs.randn(lead[0], di, ds) * 0.5).astype(f))
    return args, cts


def _both(arrays, xdtype, xc_at=0):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[xdtype]
    j = [jnp.asarray(a) for a in arrays]
    j[xc_at] = j[xc_at].astype(xdtype)
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    t[xc_at] = t[xc_at].to(tdt)
    return j, t


# ---------------------------------------------------------------------------
# The backward tunables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssm_scan_bwd_matches_jax(chunk, xdtype):
    args, cts = _inputs(chunk, (2, 37), 12, 4, xdtype)
    j, t = _both(cts + args, xdtype, xc_at=2)
    want_k = jss.ssm_scan_bwd(*j, chunk=chunk)
    want_r = jref.ssm_scan_bwd(*j)
    got_k = ss.ssm_scan_bwd(*t, chunk=chunk)
    got_r = ref.ssm_scan_bwd(*t)
    assert len(got_k) == 6 and all(g.dtype == torch.float32 for g in got_k[1:])
    for got in (got_k, got_r):
        for i, (g, wk, wr) in enumerate(zip(got, want_k, want_r)):
            _close(g, wk, tol=_tol(i, xdtype))
            _close(g, wr, tol=_tol(i, xdtype))


@pytest.mark.parametrize("block_d", [8, 12])
def test_ssm_update_bwd_matches_jax(block_d):
    args, cts = _inputs(5, (3,), 12, 4, "float32")
    j, t = _both(cts + args, "float32", xc_at=2)
    want_k = jss.ssm_update_bwd.fn(*j, block_d=block_d)
    want_r = jref.ssm_update_bwd(*j)
    got = ss.ssm_update_bwd.fn(*t, block_d=block_d)       # 12: one strip, off the space
    for g, wk, wr in zip(got, want_k, want_r):
        _close(g, wk)
        _close(g, wr)


def test_the_scan_backward_is_one_adjoint_for_every_chunk():
    """Every chunk, the whole sequence included, gives the oracle's
    gradients; the chunk changes only the window."""
    args, cts = _inputs(3, (2, 37), 12, 4, "float32")
    t = [torch.from_numpy(a) for a in cts + args]
    want = ref.ssm_scan_bwd(*t)
    for chunk in (8, 32, 37, 64, 512):
        for g, w in zip(ss.ssm_scan_bwd.fn(*t, chunk=chunk), want):      # any window
            torch.testing.assert_close(g, w, rtol=0, atol=TOL * w.abs().max().item())


@pytest.mark.parametrize("site", ["ssm_scan", "ssm_update"])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_kernel_mode_gradients_match_jax_vjp(site, xdtype):
    lead = (2, 19) if site == "ssm_scan" else (3,)
    args, cts = _inputs(11, lead, 12, 4, xdtype)
    j, t = _both(args, xdtype)
    with repro.runtime(mode="kernel") as jrt:
        _, vjp = jax.vjp(lambda *a: repro.dispatch(site, *a), *j)
        want = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = [a.requires_grad_() for a in t]
    with repro_torch.runtime(mode="kernel") as rt:
        y, h = repro_torch.dispatch(site, *leaves)
        got = torch.autograd.grad((y, h), leaves, tuple(torch.from_numpy(c) for c in cts))
    assert got[0].dtype == t[0].dtype                 # xc's gradient in xc's dtype
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, np.asarray(w, np.float32), tol=_tol(i, xdtype))
    strip = lambda keys: {"|".join(k.split("|")[:1] + k.split("|")[2:]) for k in keys}
    bwd = strip(rt.telemetry.snapshot()["by_key_phase"]["bwd"])
    assert {k.split("|")[0] for k in bwd} == {f"{site}_bwd"}
    assert bwd == strip(jrt.telemetry.snapshot()["by_key_phase"]["bwd"])


def test_an_unused_final_state_takes_a_zero_cotangent():
    """Training drops the scan's final state: its cotangent arrives as
    zeros, and the gradients are those of y alone."""
    args, cts = _inputs(2, (1, 21), 8, 4, "float32")
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    with repro_torch.runtime(mode="kernel"):
        y, _ = repro_torch.dispatch("ssm_scan", *t)
        got = torch.autograd.grad(y, t, torch.from_numpy(cts[0]))
    want = ref.ssm_scan_bwd(torch.from_numpy(cts[0]), torch.zeros_like(t[5]),
                            *(a.detach() for a in t))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL * w.abs().max().item())


# ---------------------------------------------------------------------------
# The model-level tunables
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _scratch_registrations(*names):
    """``make_*_tunable`` registers its tunable in each package's registry:
    put back what was there, so no other test file sees these."""
    saved = [(reg, n, reg.get(n)) for reg in (annotate._REGISTRY, jannotate._REGISTRY)
             for n in names]
    try:
        yield
    finally:
        for reg, n, old in saved:
            if old is None:
                reg.pop(n, None)
            else:
                reg[n] = old


def test_attn_chunks_matches_jax_at_every_chunk():
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(*s).astype(np.float32) * 0.3
               for s in ((2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want_ref = tunables.attention_chunked.reference(tq, tk, tv)
    for qc, kc in ((32, 32), (32, 64), (64, 32), (512, 1024)):
        got = tunables.attention_chunked(tq, tk, tv, q_chunk=qc, k_chunk=kc)
        _close(got, jtun.attention_chunked(jq, jk, jv, q_chunk=qc, k_chunk=kc))
        torch.testing.assert_close(got, want_ref, rtol=0, atol=TOL)
    assert tunables.attention_chunked.default_config(tq, tk, tv) == {"q_chunk": 512,
                                                                    "k_chunk": 1024}


def test_mamba_chunk_matches_jax_at_every_chunk():
    jp, _ = jssm.mamba_init(jax.random.PRNGKey(0), 32, jnp.float32)
    tp = {k: to_tensor(np.asarray(v), torch.device("cpu")) for k, v in jp.items()}
    x = (np.random.RandomState(1).randn(2, 23, 32) * 0.5).astype(np.float32)
    with _scratch_registrations("mamba_chunk"):
        jt, tt = jtun.make_mamba_tunable(jp), tunables.make_mamba_tunable(tp)
        assert tt.default_config() == {"chunk": 32} and tt.space.names == jt.space.names
        with torch.no_grad():
            want_ref = tt.reference(torch.from_numpy(x))
            for chunk in (4, 8, 32, 512):
                got = tt(torch.from_numpy(x), chunk=chunk)
                _close(got, jt(jnp.asarray(x), chunk=chunk), floor=1.0)
                torch.testing.assert_close(got, want_ref, rtol=0, atol=TOL)


def test_xent_chunk_matches_jax_at_every_chunk():
    rs = np.random.RandomState(2)
    w = (rs.randn(32, 300) * 32 ** -0.5).astype(np.float32)
    x = rs.randn(2, 70, 32).astype(np.float32)
    labels = rs.randint(0, 300, (2, 70)).astype(np.int32)
    with _scratch_registrations("xent_chunk"):
        jt = jtun.make_xent_tunable(jnp.asarray(w))
        tt = tunables.make_xent_tunable(torch.from_numpy(w))
        tx, tl = torch.from_numpy(x), torch.from_numpy(labels).long()
        want_ref = tt.reference(tx, tl)
        _close(want_ref, jt.reference(jnp.asarray(x), jnp.asarray(labels)))
        for chunk in (32, 64, 128, 4096):
            got = tt(tx, tl, loss_chunk=chunk)
            _close(got, jt(jnp.asarray(x), jnp.asarray(labels), loss_chunk=chunk))
            torch.testing.assert_close(got, want_ref, rtol=TOL, atol=0)
