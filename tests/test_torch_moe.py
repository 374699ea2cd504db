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
* Reduced Mixtral-8x7B (2 layers, 4 experts top-2, window 8, f32):
  prefill logits, three decode steps at a vector ``pos`` with prompts past
  the window, ``loss_fn`` (xent and aux) and every gradient leaf; reduced
  Jamba-1.5-Large with its MoE layers: prefill and decode. Parameters are
  carried across by ``from_jax_params``; tolerance 1e-5 of max (1e-4 for
  the gradients of the router, whose softmax sums over few experts).
* The serving engine's tokens against the JAX engine's under the same
  arrivals, for both models; with capacity headroom, any arrival pattern
  gives the tokens of serving each request alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipe  # noqa: E402
from repro.distributed.sharding import Layout  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gemm import expert_gemm_pallas  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import batch_to_tensors, from_jax_params, to_tensor  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402

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
def test_own_init_has_the_jax_leaves(name):
    jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jparams, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    conv = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
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
def test_mixtral_three_decode_steps_at_vector_pos_match_jax(mixtral, mode):
    """Three slots, two of them past the window of 8: the pool routes all
    rows together (capacity 1 of 4 experts at 3 rows, top-2)."""
    j_pool, t_pool = _decode_both(mixtral, mode, (21, 11, 4))
    _close(t_pool[0]["l0"]["v"], j_pool[0]["l0"]["v"])


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


def test_jamba_with_experts_decode_matches_jax(jamba):
    """The port's kernel path (plain versions on the CPU) against JAX's
    reference path, which computes the same function without tracing the
    16 layers' Pallas kernels in interpret mode."""
    j_pool, t_pool = _decode_both(jamba, "kernel", (13, 6), jmode="reference")
    for leaf in ("h", "conv"):
        _close(t_pool[0]["l5"][leaf], j_pool[0]["l5"][leaf])


def test_prefill_dispatches_expert_gemm_three_times_a_layer(mixtral):
    _, cfg, _, tparams = mixtral
    toks = torch.from_numpy(np.arange(13)[None]).long()
    with repro_torch.runtime() as rt, torch.inference_mode():
        lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
    calls = {k: v for k, v in rt.telemetry.by_key.items() if k.startswith("expert_gemm")}
    assert sum(sum(t.values()) for t in calls.values()) == 3 * cfg.num_layers
    assert {k.split("|")[0] for k in rt.telemetry.by_key} == \
        {"matmul", "rmsnorm", "flash_attention", "expert_gemm"}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompt(length: int, seed: int) -> np.ndarray:
    return np.random.RandomState(10_000 + 17 * length + seed).randint(0, 256, length).astype(
        np.int32)


def _engine(cfg, tparams, max_batch=3):
    return ServingEngine(cfg, RUN, tparams, EngineConfig(max_batch=max_batch, max_seq=CACHE_LEN),
                         runtime=repro_torch.runtime())


@pytest.mark.parametrize("which", ["mixtral", "jamba"])
def test_same_tokens_as_the_jax_engine(request, which):
    """Default capacity (1.25): the pool's rows share it, so both engines
    must route the same slots together, free ones included."""
    jcfg, cfg, params, tparams = request.getfixturevalue(which)
    spec = [(9, 5, 0.0, 0), (19, 4, 0.8, 1), (2, 6, 0.0, 2), (11, 4, 1.0, 3)]
    j_engine = jeng.ServingEngine(
        jcfg, JRUN, params, make_host_mesh(), Layout(),
        jeng.EngineConfig(max_batch=3, max_seq=CACHE_LEN), runtime=repro.runtime(mode="reference"))
    t_engine = _engine(cfg, tparams)
    for eng, R in ((j_engine, jeng.Request), (t_engine, Request)):
        for i, (L, n, temp, seed) in enumerate(spec):
            eng.submit(R(prompt=_prompt(L, seed), max_new_tokens=n, temperature=temp,
                         seed=seed, arrival_time=float(i)))
    j_done, t_done = j_engine.serve(), t_engine.serve()
    assert [r.output.tolist() for r in t_done] == [r.output.tolist() for r in j_done]
    assert t_engine.stats["decode_steps"] == j_engine.stats["decode_steps"]
    assert t_engine.stats["prefill_tokens"] == j_engine.stats["prefill_tokens"]


def _solo_greedy(cfg, tparams, prompt, max_new):
    with torch.inference_mode():
        toks = torch.from_numpy(prompt.astype(np.int64))[None]
        logits, caches = lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
        out = [int(logits[0].argmax())]
        for step in range(min(max_new, CACHE_LEN - len(prompt)) - 1):
            logits, caches = lm.decode_step(tparams, torch.tensor([[out[-1]]]), caches,
                                            torch.tensor(len(prompt) + step), cfg, RUN)
            out.append(int(logits[0].argmax()))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("case_seed", range(2))
def test_any_arrival_pattern_matches_solo_with_headroom(case_seed):
    """With capacity_factor 8 no token is ever dropped, so the rows stop
    coupling and the solo property holds for MoE (the JAX tests set the
    same headroom)."""
    _, cfg, _, tparams = _model("mixtral_8x7b", capacity_factor=8.0)
    rs = np.random.RandomState(700 + case_seed)
    eng = _engine(cfg, tparams)
    t = 0.0
    reqs = []
    for _ in range(rs.randint(2, 6)):
        t += int(rs.randint(0, 5))
        reqs.append(Request(prompt=_prompt(int(rs.choice([2, 9, 13])), int(rs.randint(3))),
                            max_new_tokens=int(rs.randint(1, 8)), arrival_time=t))
    for r in reqs:
        eng.submit(r)
    done = eng.serve()
    assert len(done) == len(reqs)
    for r in done:
        np.testing.assert_array_equal(r.output, _solo_greedy(cfg, tparams, r.prompt,
                                                             r.max_new_tokens))


def test_serve_launcher_takes_mixtral_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "mixtral_8x7b", "--smoke", "--device", "cpu", "--requests", "3",
                "--new-tokens", "4", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens on cpu" in out
    assert "expert_gemm" in out
