"""The MoE slice in the port against the JAX package, on the CPU.

Held against JAX on identical numpy inputs:

* ``expert_gemm``: the oracle and the kernel's plain version against
  ``ref.expert_gemm`` and ``expert_gemm_pallas`` (interpret mode) at
  ragged shapes, in f32 (2e-5 of max: the same fp32 sums in another order)
  and bf16 (1e-2 of max: both round one fp32 sum to bf16, at most a bf16
  step apart); its gradients through the dispatch plane, whose backward
  keys are ``expert_gemm`` keys on the transposed shapes.
* ``moe_apply``, scatter and dense, with and without ``true_len``: outputs
  and aux (1e-5 of max); which tokens capacity drops; pads take no
  capacity; ties in the router pick JAX's experts.

The reduced models (Mixtral-8x7B, Jamba-1.5-Large with its experts) and
their engines are held against JAX in ``test_torch_moe_models.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gemm import expert_gemm_pallas  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402

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
# expert_gemm
# ---------------------------------------------------------------------------

RAGGED = [  # (e, c, k, n, bc, bn, bk) of the JAX package's own parity test
    (2, 12, 16, 8, 8, 8, 8),
    (4, 7, 5, 9, 16, 16, 16),
    (1, 32, 8, 16, 8, 8, 8),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,k,n,bc,bn,bk", RAGGED)
def test_expert_gemm_matches_jax(dtype, e, c, k, n, bc, bn, bk):
    rs = np.random.RandomState(e * 100 + c)
    xn, wn = rs.randn(e, c, k).astype(np.float32), rs.randn(e, k, n).astype(np.float32)
    jx, jw = jnp.asarray(xn, dtype), jnp.asarray(wn, dtype)
    x, w = to_tensor(np.asarray(jx), "cpu"), to_tensor(np.asarray(jw), "cpu")
    want = jref.expert_gemm(jx, jw)
    pallas = expert_gemm_pallas(jx, jw, bc=bc, bn=bn, bk=bk, interpret=True)
    tol = 2e-5 if dtype == "float32" else 1e-2
    for out in (ref.expert_gemm(x, w), mg.expert_gemm_plain(x, w), mg.expert_gemm(x, w)):
        assert out.dtype == x.dtype
        _close(out, want, tol)
        _close(out, pallas, tol)


def test_expert_gemm_gradients_match_jax_through_the_dispatch_plane():
    rs = np.random.RandomState(0)
    xn, wn = rs.randn(2, 12, 16).astype(np.float32), rs.randn(2, 16, 8).astype(np.float32)
    with repro.runtime(mode="kernel") as jrt:
        gx, gw = jax.grad(lambda a, b: (repro.dispatch("expert_gemm", a, b) ** 2).sum(),
                          argnums=(0, 1))(jnp.asarray(xn), jnp.asarray(wn))
    x, w = (torch.from_numpy(a).requires_grad_() for a in (xn, wn))
    with repro_torch.runtime(mode="kernel") as rt:
        tx, tw = torch.autograd.grad((repro_torch.dispatch("expert_gemm", x, w) ** 2).sum(),
                                     (x, w))
    _close(tx, gx, 2e-5)
    _close(tw, gw, 2e-5)
    strip = lambda keys: {"|".join(k.split("|")[:1] + k.split("|")[2:]) for k in keys}
    bwd = strip(rt.telemetry.snapshot()["by_key_phase"]["bwd"])
    # dx = ct [2,12,8] @ w^T [2,8,16]; dw = x^T [2,16,12] @ ct [2,12,8] (bucketed)
    assert bwd == {"expert_gemm|2x16x8/2x8x16|float32", "expert_gemm|2x16x16/2x16x8|float32"}
    assert bwd == strip(jrt.telemetry.snapshot()["by_key_phase"]["bwd"])


def test_expert_gemm_space_is_the_tile_loops():
    assert mg.expert_gemm.default_config(torch.empty(8, 2, 4096), torch.empty(8, 4096, 14336)) \
        == {"bc": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1}
    assert mg.expert_gemm.default_config(torch.empty(8, 640, 4096),
                                         torch.empty(8, 4096, 14336)) == \
        {"bc": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 1}
    assert mg.expert_gemm.default_config(torch.empty(8, 37, 4096),
                                         torch.empty(8, 4096, 14336))["bc"] == 64
    # the down projection at decode: 64 column tiles an expert, 512 for the
    # 8 experts, fill the card without a split
    assert mg.expert_gemm.default_config(torch.empty(8, 2, 14336),
                                         torch.empty(8, 14336, 4096))["splits"] == 1
    assert not mg.EXPERT_GEMM_SPACE.is_valid({"bc": 256, "bn": 128, "bk": 64, "stages": 2,
                                              "splits": 1})                   # no 256-row tile
    assert not mg.EXPERT_GEMM_SPACE.is_valid({"bc": 128, "bn": 256, "bk": 128, "stages": 3,
                                              "splits": 1})                   # smem
    assert mg.EXPERT_GEMM_SPACE.is_valid({"bc": 128, "bn": 256, "bk": 128, "stages": 2,
                                          "splits": 16})


def test_expert_layout_reads_swapaxes_views_in_place():
    x = torch.empty(8, 640, 4096)
    assert mg.expert_layout(x) == (False, 4096, 640 * 4096)
    assert mg.expert_layout(x.transpose(1, 2)) == (True, 4096, 640 * 4096)
    assert mg.expert_layout(torch.empty(5, 3)[None].expand(4, 5, 3)) == (False, 3, 0)
    with pytest.raises(ValueError):
        mg.expert_layout(torch.empty(2, 6, 8)[:, :, ::2])


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

D, FF = 8, 16


def _moe_params(seed, e, router=None):
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), D, FF, e, jnp.float32)
    if router is not None:
        p["router"] = jnp.asarray(router, jnp.float32)
    return p, {k: to_tensor(np.asarray(v), "cpu") for k, v in p.items()}


def _both_moe(jp, tp, x, **kw):
    jtl = kw.pop("true_len", None)
    with repro.runtime(mode="kernel"):
        jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), true_len=None if jtl is None
                                  else jnp.asarray(jtl), **kw)
    with repro_torch.runtime(mode="kernel"):
        ty, taux = moe.moe_apply(tp, torch.from_numpy(x), true_len=jtl, **kw)
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
@pytest.mark.parametrize("true_len", [None, 5, [3, 12]], ids=["none", "scalar", "rows"])
@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (1, 0.5), (2, 8.0)])
def test_moe_apply_matches_jax(dispatch, true_len, top_k, cf):
    jp, tp = _moe_params(1, 4)
    x = np.random.RandomState(7).randn(2, 12, D).astype(np.float32)
    (jy, jaux), (ty, taux) = _both_moe(jp, tp, x, top_k=top_k, capacity_factor=cf,
                                       dispatch=dispatch, true_len=true_len)
    _close(ty, jy)
    _close(taux, jaux)


def test_capacity_overflow_drops_exactly_the_late_tokens():
    """Everything routes to expert 0 with room for 4 of 16 tokens: the first
    4 in the flat (token-major) order keep their dense-oracle output, the
    rest are dropped to zero, as in JAX."""
    router = np.concatenate([np.full((D, 1), 10.0), np.full((D, 1), -10.0)], axis=1)
    jp, tp = _moe_params(0, 2, router)
    x = (np.abs(np.random.RandomState(0).randn(2, 8, D)) + 0.1).astype(np.float32)
    cap = moe.expert_capacity(16, 2, 1, 0.5)
    assert cap == jmoe.expert_capacity(16, 2, 1, 0.5) == 4
    (jy, _), (ty, _) = _both_moe(jp, tp, x, top_k=1, capacity_factor=0.5)
    with repro_torch.runtime():
        yd, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=1, capacity_factor=0.5,
                              dispatch="dense")
    y2, yd2 = ty.reshape(-1, D), yd.reshape(-1, D)
    torch.testing.assert_close(y2[:cap], yd2[:cap], rtol=2e-5, atol=2e-5)
    assert torch.equal(y2[cap:], torch.zeros_like(y2[cap:]))
    _close(ty, jy)


def test_capacity_truncates_like_the_reference():
    for n, e, k, cf in ((8, 8, 2, 1.25), (2048, 8, 2, 1.25), (8192, 8, 2, 1.25), (7, 3, 2, 1.3),
                        (13, 16, 2, 1.25), (1, 4, 1, 1.0)):
        assert moe.expert_capacity(n, e, k, cf) == jmoe.expert_capacity(n, e, k, cf)
    assert moe.expert_capacity(8, 8, 2, 1.25) == 2
    assert moe.expert_capacity(2048, 8, 2, 1.25) == 640
    assert moe.expert_capacity(8192, 8, 2, 1.25) == 2560


def test_pad_tokens_take_no_capacity():
    """Row 0 is 2 real tokens and 6 pads, row 1 is 8 real tokens, all bound
    for expert 0 with room for exactly the 10 real ones: no real token of
    row 1 may lose its slot to row 0's pads."""
    router = np.concatenate([np.full((D, 1), 10.0), np.full((D, 1), -10.0)], axis=1)
    jp, tp = _moe_params(0, 2, router)
    x = (np.abs(np.random.RandomState(1).randn(2, 8, D)) + 0.1).astype(np.float32)
    (jy, jaux), (ty, taux) = _both_moe(jp, tp, x, top_k=1, capacity_factor=1.25,
                                       true_len=[2, 8])
    _close(ty, jy)
    _close(taux, jaux)
    assert bool((ty[1].abs().sum(-1) > 0).all())
    assert torch.equal(ty[0, 2:], torch.zeros_like(ty[0, 2:]))


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
def test_real_prefix_is_invariant_to_padding(dispatch):
    jp, tp = _moe_params(0, 2)
    x_real = (np.abs(np.random.RandomState(2).randn(1, 6, D)) + 0.1).astype(np.float32)
    got = []
    for pad in (2, 10):
        x = np.pad(x_real, ((0, 0), (0, pad), (0, 0)), constant_values=0.9)
        with repro_torch.runtime():
            y, aux = moe.moe_apply(tp, torch.from_numpy(x), top_k=2, capacity_factor=4.0,
                                   dispatch=dispatch, true_len=6)
        got.append((y[:, :6], aux))
    torch.testing.assert_close(got[0][0], got[1][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[0][1], got[1][1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("router", ["zeros", "twin_columns"])
def test_router_ties_pick_the_jax_experts(router):
    """A zero router ties all four experts on every token; twin columns tie
    two of them. ``jax.lax.top_k`` takes the lower index first, and so must
    the port."""
    r = np.zeros((D, 4), np.float32)
    if router == "twin_columns":
        r[:, 1] = r[:, 3] = np.random.RandomState(3).randn(D)
    x = np.random.RandomState(4).randn(10, D).astype(np.float32)
    jw, jids, jaux = jmoe._route(jnp.asarray(r), jnp.asarray(x), 2)
    tw, tids, taux = moe._route(torch.from_numpy(r), torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw)
    _close(taux, jaux)
    if router == "zeros":
        assert (tids.numpy() == [0, 1]).all()


def test_scatter_hinted_names_the_distributed_slice():
    _, tp = _moe_params(0, 2)
    with pytest.raises(NotImplementedError, match="distributed slice"):
        moe.moe_apply(tp, torch.zeros(1, 2, D), top_k=1, dispatch="scatter_hinted")
