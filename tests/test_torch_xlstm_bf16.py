"""The xLSTM mixers in bf16 against fp32 at full width, the JAX package and
the port on the same parameters and inputs: what a bf16 run of each mixer
can be held to, and a witness that the port's bf16 path follows the
reference's.

* One sLSTM layer (d 2048, 4 heads, 130 tokens, the JAX init, a unit-RMS
  input as the layer's norm gives it): JAX bf16 sits 5.5e-3 from JAX fp32,
  the port's bf16 4.2e-3 from JAX's bf16 and 5.1e-3 from its fp32 (this
  seed, on the CPU): the recurrence does not amplify bf16 roundings, and
  each is held within 2e-2 (``tests/test_torch_xlstm.py``'s bf16
  tolerance). What does read far from fp32 is the layer's output less its
  input when the sum is taken in bf16: with no FFN, the layer adds y to a
  residual stream whose unit in the last place is a large part of |y|, so
  ``round(x + y) - x`` sits over 0.1 from y. The card's layer gates read
  the mixer's y for that reason (``chip_smoke.py``: ``MixerTap``).
* One mLSTM layer (d 2048, 4 heads, 512 tokens, chunk 64), its gradients
  for an output cotangent of 1e-2 x N(0, 1): the reference's own bf16
  gradients of wq, wk, in_proj, w_gates, b_gates and the input sit 5.8e-2
  to 9.0e-2 from its fp32 ones, over TOL_GRAD (3e-2), and those of wv,
  out_proj and norm_scale, and the output, under 1e-2 (this seed); the
  port's bf16 gradients sit within 1e-2 of JAX's bf16 ones on every leaf.
  The backward through the chunkwise recurrence is where the reference's
  bf16 leaves fp32, so the card's step-1 gate pins that recurrence inside
  each mLSTM layer (``chip_smoke.py``: ``LayerTap``).

About 30 s on the CPU; ``-s`` prints each reading.
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

D, H = 2048, 4
TOL_BF16 = 2e-2
TOL_GRAD = 3e-2


def _rel(a, b) -> float:
    a, b = (np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t, np.float32)
            for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _both(p):
    """(JAX params in bf16, JAX params in fp32, the port's in bf16, in fp32)."""
    pf = {k: v.astype(jnp.float32) for k, v in p.items()}
    tp = lambda q: {k: to_tensor(np.asarray(v), "cpu") for k, v in q.items()}
    return p, pf, tp(p), tp(pf)


def test_slstm_bf16_stays_near_fp32_and_the_bf16_residual_sum_does_not():
    p, _ = jssm.slstm_init(jax.random.PRNGKey(0), D, H, jnp.bfloat16)
    jb, jf, tb, tf = _both(p)
    x = jnp.asarray(np.random.RandomState(1).randn(1, 130, D).astype(np.float32))
    xb = x.astype(jnp.bfloat16)
    with repro.runtime(mode="reference"):
        yjb = jssm.slstm_forward(jb, xb, n_heads=H).astype(jnp.float32)
        yjf = jssm.slstm_forward(jf, xb.astype(jnp.float32), n_heads=H)
    with repro_torch.runtime(mode="reference"), torch.no_grad():
        xt = to_tensor(np.asarray(xb), "cpu")
        ytb = ssm.slstm_forward(tb, xt, n_heads=H)
        ytf = ssm.slstm_forward(tf, xt.float(), n_heads=H)
    # the layer's output less its input, summed in bf16 as the model does
    add = (xt + ytb).float() - xt.float()
    got = {"jax bf16 / jax fp32": _rel(yjb, yjf), "port bf16 / jax bf16": _rel(ytb.float(), yjb),
           "port bf16 / jax fp32": _rel(ytb.float(), yjf), "port fp32 / jax fp32": _rel(ytf, yjf),
           "bf16 x + y less x / jax fp32 y": _rel(add, yjf)}
    print("sLSTM, ||a - b|| / ||b||:", {k: f"{v:.3e}" for k, v in got.items()})
    assert got["jax bf16 / jax fp32"] < TOL_BF16
    assert got["port bf16 / jax bf16"] < TOL_BF16
    assert got["port bf16 / jax fp32"] < TOL_BF16
    assert got["port fp32 / jax fp32"] < 1e-5
    assert got["bf16 x + y less x / jax fp32 y"] > 0.1


def test_mlstm_bf16_gradients_leave_fp32_in_the_reference_and_the_port_follows_it():
    p, _ = jssm.mlstm_init(jax.random.PRNGKey(0), D, H, jnp.bfloat16)
    jb, jf, tb, tf = _both(p)
    rs = np.random.RandomState(1)
    x = jnp.asarray(rs.randn(1, 512, D).astype(np.float32)).astype(jnp.bfloat16)
    ct = jnp.asarray((rs.randn(1, 512, D) * 1e-2).astype(np.float32)).astype(jnp.bfloat16)

    def jax_grads(params, xx, cc):
        with repro.runtime(mode="reference"):
            y, vjp = jax.vjp(lambda q, z: jssm.mlstm_forward(q, z, n_heads=H, chunk=64),
                             params, xx)
            gp, gx = vjp(cc.astype(y.dtype))
        return {**{k: np.asarray(v.astype(jnp.float32)) for k, v in gp.items()},
                "x": np.asarray(gx.astype(jnp.float32))}

    def port_grads(params):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xt = to_tensor(np.asarray(x), "cpu").requires_grad_()
        with repro_torch.runtime(mode="reference"):
            y = ssm.mlstm_forward(leaves, xt, n_heads=H, chunk=64)
            gs = torch.autograd.grad(y, list(leaves.values()) + [xt],
                                     to_tensor(np.asarray(ct), "cpu").to(y.dtype))
        return {k: g.float().numpy() for k, g in zip(list(leaves) + ["x"], gs)}

    g_jb = jax_grads(jb, x, ct)
    g_jf = jax_grads(jf, x.astype(jnp.float32), ct.astype(jnp.float32))
    g_tb = port_grads(tb)
    far = {"wq", "wk", "in_proj", "w_gates", "b_gates", "x"}
    print("mLSTM gradients, ||a - b|| / ||b||, jax bf16 / jax fp32 and port bf16 / jax bf16:",
          {k: f"{_rel(g_jb[k], g_jf[k]):.3e} {_rel(g_tb[k], g_jb[k]):.3e}" for k in g_jb})
    for k in g_jb:
        ref_bf16 = _rel(g_jb[k], g_jf[k])
        assert (ref_bf16 > TOL_GRAD) == (k in far), (k, ref_bf16)
        if k not in far:
            assert ref_bf16 < 1e-2, (k, ref_bf16)
        assert _rel(g_tb[k], g_jb[k]) < 1e-2, (k, _rel(g_tb[k], g_jb[k]))
