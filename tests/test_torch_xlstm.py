"""The port's xLSTM mixers (mLSTM and sLSTM) against the JAX package's.

The parameters come from ``repro.models.ssm.*_init`` and the inputs from a
numpy seed; both cross to the port through numpy. Held against JAX:

* ``mlstm_forward`` and ``slstm_forward``, with and without the state, in
  f32 and bf16 (reference mode: the projections are plain matmuls on both
  sides), and once in kernel mode (JAX: Pallas in interpret mode; the port:
  its kernels' plain versions), at d = 32, 4 heads, 24 steps, the mLSTM at
  chunk 8 and at a chunk that leaves a ragged last chunk (s = 19);
* ``mlstm_decode`` and ``slstm_decode``, one step from a nonzero state.

And in the port alone, as ``tests/test_ssm.py`` and
``tests/test_state_continuity.py`` hold the JAX package: the chunkwise
mLSTM and the sLSTM loop equal their decode step run token by token; the
mLSTM's chunk changes nothing (1, 6, 12, 64 against the whole sequence in
one chunk); a prefill of 13 or 24 tokens then decode reproduces the full
forward; inputs x20 give no NaN.

Tolerances, of max|JAX| (at least 1e-3): f32 1e-5 -- the same fp32 math,
sums in another order, through at most 24 steps of a recurrence whose
decay is at most 1. bf16 2e-2 -- the projections' outputs round to bf16 on
both sides, and where the two fp32 sums lie either side of a rounding
boundary they differ by one bf16 step (2^-8 of the value), which the fp32
recurrence and the down-projection carry on. The port-only invariants use
the JAX tests' own: 1e-4 relative and absolute (the mLSTM's state 1e-4),
continuity 2e-4 (sLSTM: 2e-4 relative, 2e-5 absolute).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

B, S, D, H = 2, 24, 32, 4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INIT = {"mlstm": (jssm.mlstm_init, ssm.mlstm_init), "slstm": (jssm.slstm_init, ssm.slstm_init)}


def _params(mixer, dtype="float32", seed=0):
    """(JAX params, the port's params carried across through numpy)."""
    p, _ = INIT[mixer][0](jax.random.PRNGKey(seed), D, H, jnp.dtype(dtype))
    return p, {k: to_tensor(np.asarray(v), "cpu") for k, v in p.items()}


def _x(seed=1, s=S, dtype="float32", scale=0.5):
    """numpy input; in bf16, values bf16 holds, so both sides start equal."""
    x = (np.random.RandomState(seed).randn(B, s, D) * scale).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, to_tensor(np.asarray(jx), "cpu")


def _close(t, j, tol):
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.detach().float().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max()
    assert err <= tol * max(np.abs(j).max(), 1e-3), (err, np.abs(j).max())


def _forward(mixer, p, x, **kw):
    if mixer == "mlstm":
        return (jssm if isinstance(x, jax.Array) else ssm).mlstm_forward(p, x, n_heads=H, **kw)
    return (jssm if isinstance(x, jax.Array) else ssm).slstm_forward(p, x, n_heads=H, **kw)


def _decode(mixer, p, x, state):
    mod = jssm if isinstance(x, jax.Array) else ssm
    fn = mod.mlstm_decode if mixer == "mlstm" else mod.slstm_decode
    return fn(p, x, state, n_heads=H)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer,s,kw", [("mlstm", S, {"chunk": 8}), ("mlstm", 19, {"chunk": 8}),
                                        ("slstm", S, {})], ids=["mlstm", "mlstm-ragged", "slstm"])
def test_forward_matches_jax(mixer, s, kw, dtype, return_state):
    jp, tp = _params(mixer, dtype)
    jx, tx = _x(s=s, dtype=dtype)
    with repro.runtime(mode="reference"):
        jout = _forward(mixer, jp, jx, return_state=return_state, **kw)
    with repro_torch.runtime(mode="reference"), torch.no_grad():
        tout = _forward(mixer, tp, tx, return_state=return_state, **kw)
    if not return_state:
        jout, tout = (jout, {}), (tout, {})
    assert tout[0].dtype == TDT[dtype]
    _close(tout[0], jout[0], TOL[dtype])
    assert set(tout[1]) == set(jout[1])
    for k in jout[1]:
        assert tout[1][k].dtype == torch.float32, k
        _close(tout[1][k], jout[1][k], TOL[dtype])


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_forward_in_kernel_mode_matches_jax(mixer):
    """The projections through the dispatched kernels: JAX's Pallas matmul
    in interpret mode, the port's kernels' plain versions."""
    jp, tp = _params(mixer)
    jx, tx = _x()
    with repro.runtime(mode="kernel"):
        jy, js = _forward(mixer, jp, jx, return_state=True)
    with repro_torch.runtime(mode="kernel") as rt, torch.no_grad():
        ty, ts = _forward(mixer, tp, tx, return_state=True)
    _close(ty, jy, TOL["float32"])
    for k in js:
        _close(ts[k], js[k], TOL["float32"])
    assert {k.split("|")[0] for k in rt.telemetry.by_key} == {"matmul"}
    assert "reference" not in rt.telemetry.tiers


def _state(mixer, seed=5):
    """A nonzero state in the mixer's ranges (the normalizers n > 0)."""
    rs = np.random.RandomState(seed)
    f = np.float32
    if mixer == "mlstm":
        hd = 2 * D // H
        st = {"C": rs.randn(B, H, hd, hd) * 0.3, "n": rs.randn(B, H, hd) * 0.5,
              "m": rs.randn(B, H)}
    else:
        st = {"c": rs.randn(B, D), "n": np.abs(rs.randn(B, D)) + 0.5, "h": rs.randn(B, D) * 0.3,
              "m": rs.randn(B, D)}
    st = {k: v.astype(f) for k, v in st.items()}
    return {k: jnp.asarray(v) for k, v in st.items()}, {k: torch.from_numpy(v)
                                                         for k, v in st.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_decode_step_from_a_nonzero_state_matches_jax(mixer, dtype):
    jp, tp = _params(mixer, dtype)
    jx, tx = _x(s=1, dtype=dtype, seed=3)
    jst, tst = _state(mixer)
    with repro.runtime(mode="reference"):
        jy, jnew = _decode(mixer, jp, jx, jst)
    with repro_torch.runtime(mode="reference"), torch.no_grad():
        ty, tnew = _decode(mixer, tp, tx, tst)
    _close(ty, jy, TOL[dtype])
    assert set(tnew) == set(jnew)
    for k in jnew:
        _close(tnew[k], jnew[k], TOL[dtype])
    # the caller's state is not written: the pool copies the new state back
    for k, v in _state(mixer)[1].items():
        assert torch.equal(tst[k], v), k


def _zero_state(mixer, b=B):
    shapes = (ssm.mlstm_state_shapes(b, D, H) if mixer == "mlstm"
              else ssm.slstm_state_shapes(b, D))
    return {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in shapes.items()}


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_parallel_equals_sequential(mixer):
    _, tp = _params(mixer)
    _, x = _x()
    kw = {"chunk": 8} if mixer == "mlstm" else {}
    with torch.no_grad():
        y_par, st_par = _forward(mixer, tp, x, return_state=True, **kw)
        state, ys = _zero_state(mixer), []
        for t in range(S):
            yt, state = _decode(mixer, tp, x[:, t:t + 1], state)
            ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y_par, rtol=1e-4, atol=1e-4)
    for k in st_par:
        torch.testing.assert_close(st_par[k], state[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [1, 6, 12, 64])
def test_mlstm_chunk_invariance(chunk):
    """The chunk is a schedule, not math: each chunk gives the output and
    the state of the whole sequence in one chunk (64 > s takes s)."""
    _, tp = _params("mlstm")
    _, x = _x()
    with torch.no_grad():
        base, st0 = ssm.mlstm_forward(tp, x, n_heads=H, chunk=S, return_state=True)
        out, st = ssm.mlstm_forward(tp, x, n_heads=H, chunk=chunk, return_state=True)
    torch.testing.assert_close(out, base, rtol=1e-4, atol=1e-4)
    for k in st0:
        torch.testing.assert_close(st[k], st0[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s_prefix", [13, 24])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_prefill_state_continuity(mixer, s_prefix):
    _, tp = _params(mixer)
    _, x = _x()
    kw = {"chunk": 8} if mixer == "mlstm" else {}
    with torch.no_grad():
        y_full = _forward(mixer, tp, x, **kw)
        y_pre, state = _forward(mixer, tp, x[:, :s_prefix], return_state=True, **kw)
        ys = [y_pre]
        for t in range(s_prefix, S):
            yt, state = _decode(mixer, tp, x[:, t:t + 1], state)
            ys.append(yt)
    atol = 2e-4 if mixer == "mlstm" else 2e-5
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-4, atol=atol)


def test_slstm_unroll_changes_nothing():
    _, tp = _params("slstm")
    _, x = _x()
    with torch.no_grad():
        base = ssm.slstm_forward(tp, x, n_heads=H, unroll=1)
        assert torch.equal(ssm.slstm_forward(tp, x, n_heads=H, unroll=4), base)


def test_no_nans_with_extreme_gates():
    """Exp gating stays stabilized for inputs x20, forward and decode."""
    for mixer in ("mlstm", "slstm"):
        _, tp = _params(mixer)
        _, x = _x(scale=10.0)
        kw = {"chunk": 8} if mixer == "mlstm" else {}
        with torch.no_grad():
            y, state = _forward(mixer, tp, x, return_state=True, **kw)
            yd, new = _decode(mixer, tp, x[:, :1], state)
        assert torch.isfinite(y).all() and torch.isfinite(yd).all(), mixer
        assert all(torch.isfinite(v).all() for v in new.values()), mixer
