"""Hybrid (Mamba) training against the JAX package's, without experts:
reduced Jamba-1.5-Large. The loss and every gradient leaf in kernel mode
(JAX: Pallas in interpret mode and its ``ssm_scan_bwd``; port: the
kernels' plain versions, the scan's gradient through the dispatched
``ssm_scan_bwd``), with the tolerances of
``test_torch_hybrid_train.py`` (its docstring). A file of its own: the
slowest case of the four hybrid training files, on a worker of its own.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_hybrid_train import _model, check_loss_and_every_gradient_leaf  # noqa: E402


@pytest.fixture(scope="module", params=[False], ids=["dense"])
def jamba(request):
    return _model(request.param)


@pytest.mark.parametrize("mode", ["kernel"])
def test_loss_and_every_gradient_leaf_match_jax(jamba, mode):
    check_loss_and_every_gradient_leaf(jamba, mode)
