"""Hybrid (Mamba) training against the JAX package's with experts: reduced
Jamba-1.5-Large with an MoE FFN every second layer (4 experts top-2).

The cases and tolerances of ``test_torch_hybrid_train.py`` (its docstring),
run here on the model with experts so the two models land on two workers;
the kernel-mode loss and gradients in
``test_torch_hybrid_train_experts_kernel.py``.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_hybrid_train import (  # noqa: E402,F401
    _model,
    test_loss_and_every_gradient_leaf_match_jax,
    test_remat_full_recomputes_the_reference_gradients,
    test_two_trainer_steps_match_jax,
)


@pytest.fixture(scope="module", params=[True], ids=["experts"])
def jamba(request):
    return _model(request.param)
