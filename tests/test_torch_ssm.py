"""The port's selective scan and Mamba mixer against the JAX package's.

Inputs are made from a seed with numpy and go through both packages:

* ``ssm_scan``: the port's plain version (the CPU side of its kernel's
  wrapper) and its Reference tier ``ssm_scan_chunked`` against the JAX
  Pallas kernel in interpret mode, the JAX ``ssm_scan_chunked`` and the
  sequential ``ref.ssm_scan`` -- y and the final state, xc in f32 and bf16,
  a nonzero carry-in, ragged tails (s = 1, 12, 37 at chunk 8) and a
  d_inner (12) that is not a multiple of the kernel's block_d (8).
* ``ssm_update``: the same against ``ssm_update_pallas`` and
  ``ref.ssm_update`` at b = 3 and a ragged d_inner.
* The Mamba mixer (``mamba_forward`` with and without its state,
  ``mamba_decode``) against JAX at d = 64 with the JAX parameters carried
  across, in kernel and in reference mode, prompts shorter than the conv
  tail included; the port's prefill -> decode state continuity.

Tolerance: 1e-5 of max|reference| (at least 1 for the mixer's outputs).
Both sides compute in fp32; the kernels take exp as exp2 of a log2-scaled
A and the sums run in another order, each about 1e-7 relative, over at
most 37 steps of a recurrence whose factor is at most 1.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.core.annotate import DispatchSpec, Tunable, registered  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

# the module (``repro.kernels`` re-exports the tunable under its name)
jss = importlib.import_module("repro.kernels.ssm_scan")

TOL = 1e-5
D_MIX = 64


def _close(t, j, floor=1e-6):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= TOL * max(np.abs(j).max(), floor), np.abs(t - j).max()


def _inputs(seed, lead, di, ds, xdtype):
    """numpy inputs in the mixer's ranges: dt > 0, A < 0, a nonzero carry."""
    rs = np.random.RandomState(seed)
    f = np.float32
    xc = (rs.randn(*lead, di) * 0.5).astype(f)
    if xdtype == "bfloat16":             # values bf16 can hold, on both sides
        xc = np.asarray(jnp.asarray(xc, jnp.bfloat16).astype(jnp.float32))
    return (xc, (np.abs(rs.randn(*lead, di)) * 0.1 + 0.01).astype(f),
            (rs.randn(*lead, ds) * 0.5).astype(f), (rs.randn(*lead, ds) * 0.5).astype(f),
            (-np.abs(rs.randn(di, ds)) - 0.1).astype(f),
            (rs.randn(lead[0], di, ds) * 0.3).astype(f))


def _both(arrays, xdtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[xdtype]
    j = [jnp.asarray(a) for a in arrays]
    j[0] = j[0].astype(xdtype)
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    t[0] = t[0].to(tdt)
    return j, t


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 12, 37])
def test_ssm_scan_matches_jax(s, xdtype):
    j, t = _both(_inputs(s, (2, s), 12, 4, xdtype), xdtype)
    jy_k, jh_k = jss.ssm_scan_pallas(*j, chunk=8, block_d=8, interpret=True)
    jy_c, jh_c = jss.ssm_scan_chunked(*j, chunk=8)
    jy_r, jh_r = jref.ssm_scan(*j)
    ty_p, th_p = ss.ssm_scan(*t, chunk=8, block_d=32)       # the wrapper: plain on the CPU
    ty_c, th_c = ss.ssm_scan_chunked(*t, chunk=8)
    ty_r, th_r = ref.ssm_scan(*t)
    assert ty_p.dtype == th_p.dtype == torch.float32
    for ty, th in ((ty_p, th_p), (ty_c, th_c), (ty_r, th_r)):
        for jy, jh in ((jy_k, jh_k), (jy_c, jh_c), (jy_r, jh_r)):
            _close(ty, jy)
            _close(th, jh)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_ssm_update_matches_jax(xdtype):
    j, t = _both(_inputs(7, (3,), 12, 4, xdtype), xdtype)
    jy_k, jh_k = jss.ssm_update_pallas(*j, block_b=8, block_d=8, interpret=True)
    jy_r, jh_r = jref.ssm_update(*j)
    ty_p, th_p = ss.ssm_update(*t, block_b=2, block_d=32, lanes=4)
    ty_r, th_r = ref.ssm_update(*t)
    for ty, th in ((ty_p, th_p), (ty_r, th_r)):
        for jy, jh in ((jy_k, jh_k), (jy_r, jh_r)):
            _close(ty, jy)
            _close(th, jh)


def test_chunked_form_is_one_recurrence_for_every_chunk():
    _, t = _both(_inputs(3, (2, 37), 12, 4, "float32"), "float32")
    y0, h0 = ref.ssm_scan(*t)
    for chunk in (1, 8, 16, 37, 64):
        y, h = ss.ssm_scan_chunked(*t, chunk=chunk)
        torch.testing.assert_close(y, y0, rtol=0, atol=0)
        torch.testing.assert_close(h, h0, rtol=0, atol=0)


def test_every_tunable_example_matches_its_reference():
    """Each tunable that declares an example runs it (plain on the CPU) and
    matches its reference."""
    with_example = {n: t for n, t in registered().items() if t.dispatch and t.dispatch.example}
    assert {"ssm_scan", "ssm_update"} <= set(with_example)
    for name, tun in with_example.items():
        args, kw = tun.dispatch.example()
        out, want = tun(*args, **kw), tun.dispatch.reference_for(tun)(*args, **kw)
        for o, w in zip(out, want):
            torch.testing.assert_close(o, w, rtol=TOL, atol=TOL * w.abs().max().item())


def test_heuristics_are_legal_at_the_served_shapes():
    for b, s, di in ((1, 2048, 16384), (1, 1500, 16380), (1, 1500, 16384), (1, 8, 16384),
                     (8, 2048, 16384), (1, 37, 128), (2, 12, 12)):
        xc = torch.empty((b, s, di))
        cfg = ss.ssm_scan.default_config(xc, xc, *(torch.empty(0),) * 4)
        assert ss.SSM_SCAN_SPACE.is_valid(cfg)
        assert ss.scan_smem_bytes(cfg, 16, 2) <= ss.scan_smem_bytes(cfg) <= 232_448
    # four lanes a channel and 64 channels a CTA: 256 CTAs of 8 consumer warps
    # and the producer at b = 1, d_inner = 16384, so every SM has work
    assert ss.ssm_scan.default_config(torch.empty((1, 2048, 16384)), None, None, None, None,
                                      None) == {"chunk": 64, "block_d": 64, "stages": 2,
                                                "lanes": 4}
    xd = torch.empty((8, 16384))
    cfg = ss.ssm_update.default_config(xd, xd, None, None, None, None)
    assert ss.SSM_UPDATE_SPACE.is_valid(cfg)
    assert cfg == {"block_b": 8, "block_d": 64, "lanes": 4}
    assert not ss.SSM_SCAN_SPACE.is_valid({"chunk": 256, "block_d": 256, "stages": 4,
                                           "lanes": 2})
    assert not ss.SSM_UPDATE_SPACE.is_valid({"block_b": 64, "block_d": 1024})


def test_wrappers_check_before_they_launch():
    """The CUDA wrappers refuse what the kernels do not take before building
    anything, and a tensor on neither the CPU nor a card raises."""
    _, (xc, dt, B, C, A, h0) = _both(_inputs(0, (1, 5), 8, 4, "float32"), "float32")
    knobs = dict(chunk=8, block_d=32, stages=2, lanes=1)
    with pytest.raises(ValueError, match="at most 16 states"):
        big = torch.zeros(8, 32)
        ss.ssm_scan_cuda(xc, dt, torch.zeros(1, 5, 32), torch.zeros(1, 5, 32), big,
                         torch.zeros(1, 8, 32), **knobs)
    with pytest.raises(TypeError, match="fp32"):
        ss.ssm_scan_cuda(xc, dt.double(), B, C, A, h0, **knobs)
    with pytest.raises(ValueError, match="shared memory"):
        ss.ssm_scan_cuda(xc, dt, B, C, A, h0, chunk=256, block_d=256, stages=4, lanes=2)
    with pytest.raises(ValueError, match="shape"):
        ss.ssm_update_cuda(xc[:, 0], dt[:, 0], B[:, 0], C[:, 0], A, h0[:, :4], block_b=1,
                           block_d=32, lanes=4)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_update_cuda(xc[:, 0], dt[:, 0], B[:, 0], C[:, 0], A.T.contiguous().T, h0,
                           block_b=1, block_d=32, lanes=4)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ss.ssm_scan(*(t.to("meta") for t in (xc, dt, B, C, A, h0)), chunk=8, block_d=32)


def test_kernel_dispatch_refuses_a_gradient():
    """A kernel-mode dispatch on tensors that need a gradient never returns a
    tensor cut from the graph: the two SSM sites now carry one (their
    backward plans), and a site that declares no backward raises."""
    _, t = _both(_inputs(0, (1, 5), 8, 4, "float32"), "float32")
    t[0].requires_grad_()
    with repro_torch.runtime():
        y, h = repro_torch.dispatch("ssm_scan", *t)
        assert y.grad_fn is not None and h.grad_fn is not None
        y, h = repro_torch.dispatch("ssm_update", *(a[:, 0] if i < 4 else a
                                                    for i, a in enumerate(t)))
        assert y.grad_fn is not None
        toy = Tunable("toy_no_bwd", lambda xc, *, chunk: xc * 2, ss.SSM_SCAN_BWD_SPACE,
                      dispatch=DispatchSpec(vjp="none"))
        with pytest.raises(RuntimeError, match="declares no backward"):
            repro_torch.dispatch(toy, t[0])


def test_scan_space_limits():
    """The space's limits are the H100's: one warp to 512 consumer threads
    (the producer warp beside them), the ring within 227 KB in the widest
    case (fp32 xc, 16 states), and the TMA box's 256 rows and channels."""
    cfgs = list(ss.SSM_SCAN_SPACE.enumerate())
    assert len(cfgs) == 170
    for c in cfgs:
        assert 32 <= c["block_d"] * c["lanes"] <= 512 and c["lanes"] in (1, 2, 4)
        assert c["chunk"] <= 256 and c["block_d"] <= 256 and c["stages"] >= 2
        assert ss.scan_smem_bytes(c) <= 232_448
    assert {c["lanes"] for c in cfgs} == {1, 2, 4} and {c["stages"] for c in cfgs} == {2, 3, 4}
    for bad in ({"chunk": 8, "block_d": 16, "stages": 2, "lanes": 1},       # half a warp
                {"chunk": 8, "block_d": 256, "stages": 2, "lanes": 4},      # 1024 threads
                {"chunk": 256, "block_d": 128, "stages": 2, "lanes": 4},    # 264 KB
                {"chunk": 64, "block_d": 64}):          # a record of the first port's space
        assert not ss.SSM_SCAN_SPACE.is_valid(bad), bad


def test_scan_smem_bytes_by_hand():
    """xc, dt, B and C of a slice, each region rounded up to 128 bytes, two
    8-byte mbarriers a slice and 128 bytes of alignment slack."""
    heur = {"chunk": 32, "block_d": 64, "stages": 3, "lanes": 4}
    # bf16 xc 32*64*2 = 4096, dt 8192, B and C 32*16*4 = 2048 each
    assert ss.scan_smem_bytes(heur, 16, 2) == 128 + 3 * (4096 + 8192 + 2 * 2048 + 16) == 49328
    assert ss.scan_smem_bytes(heur) == 128 + 3 * (8192 + 8192 + 2 * 2048 + 16) == 61616
    # d_state 7: 8*7*4 = 224 bytes of B, rounded up to 256
    assert ss.scan_smem_bytes({"chunk": 8, "block_d": 16, "stages": 2, "lanes": 2}, 7, 4) \
        == 128 + 2 * (512 + 512 + 2 * 256 + 16) == 3232


def test_loader_rule_follows_alignment():
    """TMA where every base is 16-byte aligned and the rows of xc, dt, B and
    C are 16-byte multiples; cp.async elsewhere: the bf16 d_inner = 16380
    rows of a ragged prefill (32,760 bytes), an odd d_inner, 7 states, a
    view one element past an aligned base."""
    def args(di, ds=16, dtype=torch.bfloat16, s=4):
        return (torch.zeros(1, s, di, dtype=dtype), torch.zeros(1, s, di),
                torch.zeros(1, s, ds), torch.zeros(1, s, ds))

    assert ss.loader(*args(16384)) == "tma"
    assert ss.loader(*args(16384, dtype=torch.float32)) == "tma"
    assert ss.loader(*args(16380)) == "cpasync"
    assert ss.loader(*args(16380, dtype=torch.float32)) == "tma"    # 65,520-byte rows
    assert ss.loader(*args(33)) == "cpasync"
    assert ss.loader(*args(64, ds=7)) == "cpasync"
    xc, dt, B, C = args(64)
    shifted = torch.zeros(xc.numel() + 1, dtype=xc.dtype)[1:].view(xc.shape)
    assert ss.loader(shifted, dt, B, C) == "cpasync"


def test_update_space_limits():
    """The update's space is the H100's: block_d x lanes threads from one
    warp to 1,024, lanes 1, 2 or 4 (four: a float4 of the 16 states each),
    up to 8 rows a CTA (the 8-slot pool); a record of the first port's
    space (one thread a row and channel, no lanes) is no config of it."""
    cfgs = list(ss.SSM_UPDATE_SPACE.enumerate())
    assert len(cfgs) == 72
    for c in cfgs:
        assert 32 <= c["block_d"] * c["lanes"] <= 1024 and c["lanes"] in (1, 2, 4)
        assert 1 <= c["block_b"] <= 8
    assert {c["lanes"] for c in cfgs} == {1, 2, 4}
    assert {c["block_b"] for c in cfgs} == {1, 2, 4, 8}
    for bad in ({"block_b": 2, "block_d": 128},                # the first port's heuristic
                {"block_b": 1, "block_d": 8, "lanes": 2},      # half a warp
                {"block_b": 1, "block_d": 512, "lanes": 4},    # 2048 threads
                {"block_b": 16, "block_d": 64, "lanes": 4}):   # more rows than the pool
        assert not ss.SSM_UPDATE_SPACE.is_valid(bad), bad


@pytest.mark.parametrize("b,want_b", [(1, 1), (3, 4), (8, 8), (16, 8)])
def test_update_heuristic_takes_four_lanes_and_the_pools_rows(b, want_b):
    """Four lanes a channel, 64 channels a CTA, every row of the pool a CTA
    (so each thread reads its float4 of A once), at most 8."""
    for di in (16384, 16380, 100):
        x = torch.empty((b, di))
        cfg = ss.ssm_update.default_config(x, x, None, None, None, None)
        assert cfg == {"block_b": want_b, "block_d": 64, "lanes": 4}
        assert ss.SSM_UPDATE_SPACE.is_valid(cfg)


def test_a_record_of_the_first_update_space_falls_to_the_heuristic(tmp_path):
    from repro_torch.core import database as tdb

    _, t = _both(_inputs(7, (3,), 12, 4, "float32"), "float32")
    path = str(tmp_path / "db.json")
    db = tdb.TuningDatabase(path)
    key = repro_torch.runtime(db=db).key_for(ss.ssm_update, tuple(t), "")
    old = {"block_b": 2, "block_d": 128}
    db.put(tdb.Record(key=key, config=old, objective=1e-5, evaluator="wallclock",
                      evaluations=1, timestamp=tdb.now()))
    with repro_torch.runtime(db=tdb.TuningDatabase(path)) as rt:
        res = rt.resolve("ssm_update", tuple(t), "")
    assert res.key == key and res.tier == "heuristic"
    assert res.config == ss.ssm_update.default_config(*t) != old


# ---------------------------------------------------------------------------
# The Mamba mixer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixer():
    jp, _ = jssm.mamba_init(jax.random.PRNGKey(0), D_MIX, jnp.float32)
    tp = {k: to_tensor(np.asarray(v), torch.device("cpu")) for k, v in jp.items()}
    return jp, tp


def _x(seed, s, b=2):
    return (np.random.RandomState(seed).randn(b, s, D_MIX) * 0.5).astype(np.float32)


def test_mamba_params_carry_every_leaf_with_its_dtype():
    jp, _ = jssm.mamba_init(jax.random.PRNGKey(1), D_MIX, jnp.bfloat16)
    tp = {k: to_tensor(np.asarray(v), torch.device("cpu")) for k, v in jp.items()}
    mine = ssm.mamba_init(torch.Generator().manual_seed(0), D_MIX, torch.bfloat16, "cpu")
    assert set(tp) == set(jp) == set(mine)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == tuple(v.shape) == tuple(mine[k].shape), k
        assert str(tp[k].dtype).split(".")[1] == str(v.dtype) == str(mine[k].dtype).split(".")[1]
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(v.astype(jnp.float32)))
    assert {k for k, v in mine.items() if v.dtype == torch.float32} == {"dt_bias", "A_log", "D"}
    torch.testing.assert_close(mine["A_log"], tp["A_log"])


@pytest.mark.parametrize("mode", ["kernel", "reference"])
@pytest.mark.parametrize("s", [2, 8, 13])
def test_mamba_forward_matches_jax(mixer, mode, s):
    jp, tp = mixer
    x = _x(s, s)
    with repro.runtime(mode=mode):
        jy = jssm.mamba_forward(jp, jnp.asarray(x))
        jy2, jst = jssm.mamba_forward(jp, jnp.asarray(x), return_state=True)
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        ty = ssm.mamba_forward(tp, torch.from_numpy(x))
        ty2, tst = ssm.mamba_forward(tp, torch.from_numpy(x), return_state=True)
    _close(ty, jy, floor=1.0)
    _close(ty2, jy2, floor=1.0)
    _close(tst["h"], jst["h"], floor=1.0)
    _close(tst["conv"], jst["conv"], floor=1.0)      # zero-padded in front when s < 3
    assert tst["conv"].shape == (2, 3, 2 * D_MIX) and tst["h"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_mamba_decode_matches_jax(mixer, mode):
    jp, tp = mixer
    x = _x(5, 9)
    with repro.runtime(mode=mode):
        _, jst = jssm.mamba_forward(jp, jnp.asarray(x[:, :8]), return_state=True)
        jy, jst2 = jssm.mamba_decode(jp, jnp.asarray(x[:, 8:]), jst)
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        _, tst = ssm.mamba_forward(tp, torch.from_numpy(x[:, :8]), return_state=True)
        ty, tst2 = ssm.mamba_decode(tp, torch.from_numpy(x[:, 8:]), tst)
    _close(ty, jy, floor=1.0)
    for k in ("h", "conv"):
        _close(tst2[k], jst2[k], floor=1.0)


@pytest.mark.parametrize("s_prefix", [1, 2, 13, 17])
def test_mamba_prefill_state_continuity(mixer, s_prefix):
    """Prefill s tokens then decode the rest one at a time equals the
    full-length forward, for prefixes shorter than the conv tail too; the
    decoded outputs also match JAX's own continuation."""
    jp, tp = mixer
    x = _x(1, 24)
    with repro_torch.runtime(), torch.inference_mode():
        y_full = ssm.mamba_forward(tp, torch.from_numpy(x))
        y_pre, st = ssm.mamba_forward(tp, torch.from_numpy(x[:, :s_prefix]), return_state=True)
        ys = [y_pre]
        for t in range(s_prefix, 24):
            yt, st = ssm.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]), st)
            ys.append(yt)
    y_cont = torch.cat(ys, 1)
    torch.testing.assert_close(y_cont, y_full, rtol=2e-4, atol=2e-5)
    with repro.runtime(mode="reference"):
        jy, jst = jssm.mamba_forward(jp, jnp.asarray(x[:, :s_prefix]), return_state=True)
        jys = [jy]
        for t in range(s_prefix, 24):
            jyt, jst = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jst)
            jys.append(jyt)
    _close(y_cont, jnp.concatenate(jys, 1), floor=1.0)
