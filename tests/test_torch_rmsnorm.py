"""``rmsnorm``'s plain version against the JAX package's Pallas kernel at the
widths where the port's CUDA kernel leaves its simplest path, on the CPU.

The kernel takes element loads for a d that is not a multiple of its
16-byte vector (d = 100) and a team of warps with a shared-memory sum for a
wide row (d = 8192); its plain version, which the card holds it against,
must compute the TPU kernel's function there. The same numpy inputs go
through ``rmsnorm_pallas`` in interpret mode and the plain version, in f32
and bf16, at a few rows.

Tolerances, relative to max|JAX output| (``tests/test_torch_kernels.py``'s):
f32 1e-5 (the same fp32 math, sums in another order); bf16 2e-2 (one bf16
rounding of the output on each side). The inverse rms is fp32 on both
sides: 1e-5.

The backward's plain version is held to ``rmsnorm_bwd_pallas`` the same way
at the widths of the coming training slices (d = 4096, 8192), where the
kernel's rows take teams of warps; and the backward's wrapper is run up to
its one C call (stubbed here: the CPU has no card) for every config of
the space at every width, with its CTA count and shared memory checked by
hand.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm_bwd_pallas, rmsnorm_pallas  # noqa: E402
from repro_torch.core.runtime import dispatch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _close(t_out, j_out, tol):
    j = np.asarray(jnp.asarray(j_out).astype(jnp.float32))
    t = t_out.float().numpy()
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= tol * max(np.abs(j).max(), 1e-6), err


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,block_rows", [
    (3, 100, 8),          # the element-load tail, fewer rows than a block
    (5, 100, 2),          # odd rows: the last block holds one
    (4, 8192, 4),         # a team of 8 (bf16) or 16 (f32) warps a row
    (3, 8192, 1),
])
def test_rmsnorm_plain_matches_pallas_on_the_kernels_paths(dtype, rows, d, block_rows):
    jd, td, tol = DTYPES[dtype]
    rs = np.random.RandomState(rows * d)
    x = rs.randn(rows, d).astype(np.float32)
    w = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)
    j_out, j_r = rmsnorm_pallas(jx, jw, block_rows=block_rows, eps=1e-6, interpret=True,
                                return_residuals=True)
    t_out, t_r = rn.rmsnorm_plain(tx, tw, 1e-6)
    _close(t_out, j_out, tol)
    _close(t_r, j_r, 1e-5)
    _close(dispatch("rmsnorm", tx, tw, eps=1e-6), j_out, tol)      # CPU: the plain version


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,block_rows", [(3, 4096, 8), (2, 8192, 8)])
def test_rmsnorm_bwd_plain_matches_pallas_at_wide_rows(dtype, rows, d, block_rows):
    jd, td, tol = DTYPES[dtype]
    rs = np.random.RandomState(rows + d)
    x, ct = rs.randn(rows, d).astype(np.float32), rs.randn(rows, d).astype(np.float32)
    w = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    jx, jw, jct = (jnp.asarray(a).astype(jd) for a in (x, w, ct))
    tx, tw, tct = (torch.from_numpy(a).to(td) for a in (x, w, ct))
    _, j_r = rmsnorm_pallas(jx, jw, block_rows=block_rows, eps=1e-6, interpret=True,
                            return_residuals=True)
    _, t_r = rn.rmsnorm_plain(tx, tw, 1e-6)
    j_dx, j_dw = rmsnorm_bwd_pallas(jct, jx, jw, j_r, block_rows=block_rows, interpret=True)
    t_dx, t_dw = rn.rmsnorm_bwd_plain(tct, tx, tw, t_r)
    _close(t_dx, j_dx, tol)
    _close(t_dw, j_dw, tol)
    _close(dispatch("rmsnorm_bwd", tct, tx, tw, t_r)[1], j_dw, tol)   # CPU: the plain version


def test_rmsnorm_bwd_geometry_by_hand():
    """Teams, CTAs (512 threads an SM on 132 SMs, no more than the rows'
    teams) and shared memory at the main path's widths."""
    # bf16 d = 896: 112 vectors, two vectors a thread, two warps a row; the
    # heuristic's 4 teams give 264 CTAs of 8 warps, 8 teams 132 of 16
    assert rn.rmsnorm_bwd_team(896, 2) == (2, True, 2)
    assert rn.rmsnorm_bwd.default_config(None, torch.empty(8192, 896), None, None) \
        == {"block_rows": 4}
    assert rn.rmsnorm_bwd_ctas(8192, 896, 2, 4) == 264
    assert rn.rmsnorm_bwd_ctas(8192, 896, 2, 8) == 132
    assert rn.rmsnorm_bwd_smem_bytes(8, 896) == 8 * 896 * 4
    # Jamba's 8192: four vectors a thread, 8 warps a row, 2 teams, 132 CTAs of
    # 16 warps, 64 KB
    assert rn.rmsnorm_bwd_team(8192, 2) == (8, True, 4)
    assert rn.rmsnorm_bwd_ctas(2048, 8192, 2, 8) == 132
    assert rn.rmsnorm_bwd_smem_bytes(8, 8192) == 2 * 8192 * 4 == 65536
    # Mixtral's 4096: two vectors a thread, 8 warps, 2 teams
    assert rn.rmsnorm_bwd_team(4096, 2) == (8, True, 2)
    assert rn.rmsnorm_bwd_ctas(8192, 4096, 2, 8) == 132
    # few rows: one CTA a team's row; 16,384 bf16 fills 16 warps, one team
    assert rn.rmsnorm_bwd_ctas(8, 896, 2, 1) == 8
    assert rn.rmsnorm_bwd_ctas(0, 896, 2, 8) == 0
    assert rn.rmsnorm_bwd_team(16384, 2) == (16, True, 4)
    assert rn.rmsnorm_bwd_smem_bytes(32, 16384) == 0
    # wider rows than 16 warps hold are read twice, one team a CTA
    assert rn.rmsnorm_bwd_team(16385, 2) == (16, False, 4)
    assert rn.rmsnorm_bwd_team(8193, 4) == (16, False, 4)
    assert rn.rmsnorm_bwd_ctas(5, 20000, 2, 8) == 5
    # fp32 d = 100: 25 vectors, one warp, 16 teams
    assert rn.rmsnorm_bwd_smem_bytes(32, 100, 4) == 16 * 100 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [100, 896, 4096, 8192, 16384])
def test_rmsnorm_bwd_wrapper_admits_every_config_at_every_width(monkeypatch, dtype, d):
    """Every config of the space passes the wrapper's checks at every width
    (the first port refused d = 8192 from 8 rows on: its [block_rows, d]
    fp32 accumulator passed 227 KB), and a call makes one C call with the
    CTA count the partials were sized by."""
    calls = []

    def entry(name, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    rows = 64
    x = torch.zeros(rows, d, dtype=dtype)
    w, r = torch.ones(d, dtype=dtype), torch.ones(rows)
    for cfg in rn.RMSNORM_SPACE.enumerate():
        calls.clear()
        dx, dw = rn.rmsnorm_bwd_cuda(x, x, w, r, **cfg)
        assert dx.shape == x.shape and dw.shape == w.shape and dx.dtype == dw.dtype == dtype
        ((symbol, args),) = calls
        ctas = rn.rmsnorm_bwd_ctas(rows, d, x.element_size(), cfg["block_rows"])
        assert symbol == "repro_rmsnorm_bwd" and args[7:12] == (rows, d, rn._DTYPES[dtype],
                                                                 cfg["block_rows"], ctas)
        assert 1 <= ctas <= rows
        assert rn.rmsnorm_bwd_smem_bytes(cfg["block_rows"], d, x.element_size()) <= 65536
