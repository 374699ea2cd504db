"""The MoE slice's models decoding in the port against the JAX package, on
the CPU (the models and their prefill: ``test_torch_moe_models.py``, whose
models, helpers and tolerances these cases use; a file of its own, so the
two run on two workers).

* Reduced Mixtral-8x7B: three decode steps at a vector ``pos`` with prompts
  past the window, in kernel and reference mode;
* reduced Jamba-1.5-Large with its MoE layers: decode.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_moe_models import (  # noqa: E402,F401
    _close,
    _decode_both,
    jamba,
    mixtral,
)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_mixtral_three_decode_steps_at_vector_pos_match_jax(mixtral, mode):
    """Three slots, two of them past the window of 8: the pool routes all
    rows together (capacity 1 of 4 experts at 3 rows, top-2)."""
    j_pool, t_pool = _decode_both(mixtral, mode, (21, 11, 4))
    _close(t_pool[0]["l0"]["v"], j_pool[0]["l0"]["v"])


def test_jamba_with_experts_decode_matches_jax(jamba):
    """The port's kernel path (plain versions on the CPU) against JAX's
    reference path, which computes the same function without tracing the
    16 layers' Pallas kernels in interpret mode."""
    j_pool, t_pool = _decode_both(jamba, "kernel", (13, 6), jmode="reference")
    for leaf in ("h", "conv"):
        _close(t_pool[0]["l5"][leaf], j_pool[0]["l5"][leaf])
