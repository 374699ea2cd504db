"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips on a host with no card (the
check runs inside the fixture, never at import). On the card:

    python -m pytest -m gpu tests/test_torch_*.py

Tolerances, relative to max|plain|: f32 1e-5 (fp32 sums in another order);
bf16 1e-2 (the same fp32 sums, then one bf16 rounding of 2^-8 an element).
This file holds the kernels to their plain versions and needs no jax, which
the card's host may not have; the parity with the JAX package is held on
the CPU by the other ``test_torch_*`` files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(rs, shape, dtype, device, scale=1.0):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(device, dtype)


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * max(ref.float().abs().max().item(), 1e-6), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 896, 896), (5, 100, 37), (33, 64, 130),
                                   (256, 896, 4864), (1, 896, 151936)])
@pytest.mark.parametrize("config", [None, {"bm": 32, "bn": 64, "bk": 16},
                                    {"bm": 128, "bn": 128, "bk": 64}])
def test_matmul_kernel_matches_plain(cuda, dtype, m, k, n, config):
    rs = np.random.RandomState(m + k + n)
    x, w = _t(rs, (m, k), dtype, cuda), _t(rs, (k, n), dtype, cuda, k ** -0.5)
    cfg = config or mm.matmul.default_config(x, w)
    out = mm.matmul_cuda(x, w, **cfg)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, mm.matmul_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8, 896), (13, 100), (2048, 896)])
@pytest.mark.parametrize("block_rows", [None, 1, 32])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d, block_rows):
    rs = np.random.RandomState(rows + d)
    x, w = _t(rs, (rows, d), dtype, cuda), _t(rs, (d,), dtype, cuda)
    cfg = {"block_rows": block_rows} if block_rows else rn.rmsnorm.default_config(x, w)
    out, r = rn.rmsnorm_cuda(x, w, eps=1e-6, **cfg)
    torch.cuda.synchronize()
    p_out, p_r = rn.rmsnorm_plain(x, w, 1e-6)
    _close(out, p_out, dtype)
    _close(r, p_r, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,window,d", [(16, 16, 0, 64), (100, 100, 0, 64),
                                              (64, 128, 0, 16), (128, 128, 24, 128),
                                              (1, 77, 0, 32)])
@pytest.mark.parametrize("config", [None, {"block_q": 16, "block_k": 32},
                                    {"block_q": 128, "block_k": 64}])
def test_flash_kernel_matches_plain(cuda, dtype, s_q, s_k, window, d, config):
    rs = np.random.RandomState(s_q + s_k + d)
    q = _t(rs, (2, 4, s_q, d), dtype, cuda)
    k, v = _t(rs, (2, 2, s_k, d), dtype, cuda), _t(rs, (2, 2, s_k, d), dtype, cuda)
    cfg = config or fa.flash_attention.default_config(q, k, v)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=window, **cfg)
    torch.cuda.synchronize()
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    _close(out, p_out, dtype)
    assert (lse - p_lse).abs().max().item() <= 1e-3


def test_wrappers_count_only_kernel_launches(cuda):
    kernels.reset_launch_counts()
    x = torch.randn(4, 64, device=cuda)
    w = torch.randn(64, 32, device=cuda)
    mm.matmul(x, w)
    mm.matmul_plain(x, w)                 # the plain version is not a launch
    mm.matmul(x.cpu(), w.cpu())           # nor is the CPU path
    assert kernels.launch_counts() == {"matmul": 1}


def test_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.randn(32, 64, device=cuda).t()          # not row-major
    with pytest.raises(ValueError):
        mm.matmul(x, w)


def test_reduced_model_on_card_matches_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig

    cfg = get_config("qwen2_0_5b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    to = lambda t: t.to(cuda) if isinstance(t, torch.Tensor) else (
        {k: to(v) for k, v in t.items()} if isinstance(t, dict) else type(t)(to(v) for v in t))
    on_card = to(params)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 32)))
    run = RunConfig(q_chunk=16, k_chunk=16)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        l_gpu, _ = lm.prefill(on_card, {"tokens": toks.to(cuda)}, cfg, run, true_len=29)
        l_cpu, _ = lm.prefill(params, {"tokens": toks}, cfg, run, true_len=29)
    assert set(kernels.launch_counts()) == {"matmul", "rmsnorm", "flash_attention"}
    # two layers of fp32 sums in another order: 1e-4 of max|logit|
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    assert err <= 1e-4 * l_cpu.abs().max().item(), err
