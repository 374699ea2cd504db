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
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro_torch.core.runtime import dispatch  # noqa: E402
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
