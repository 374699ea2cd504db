"""The forward, the loss and every gradient leaf against JAX for the archs
``test_torch_arch_smoke.py`` leaves to this file (its docstring, and its
tolerances), so the ten archs' cases land on two workers."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import ARCH_NAMES  # noqa: E402
from test_torch_arch_smoke import HERE, forward_loss_and_gradients_match_jax  # noqa: E402


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a not in HERE])
def test_forward_loss_and_gradients_match_jax(arch, rs):
    forward_loss_and_gradients_match_jax(arch, rs)
