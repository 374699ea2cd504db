"""Model-level tunables: knobs above the kernel layer that change a
schedule, never the math. The port of ``repro.models.tunables``:

* ``attn_chunks`` -- the plain path's chunked attention (``q_chunk``,
  ``k_chunk``: the online softmax's working set);
* ``mamba_chunk`` (:func:`make_mamba_tunable`) -- the Mamba mixer with the
  chunked scan's ``chunk`` pinned through ``mamba_forward``'s ``scan_fn``;
* ``xent_chunk`` (:func:`make_xent_tunable`) -- the loss's sequence chunk,
  the window in which logits exist.

Each is torch code on whatever device its tensors are on (the card unless
the caller passes CPU tensors) and declares its reference, against which
the tuner gates every variant.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from ..kernels import ref
from . import ssm
from .attention import chunked_attention

ATTN_CHUNK_SPACE = ParamSpace([PowerOfTwoParam("q_chunk", 32, 2048),
                               PowerOfTwoParam("k_chunk", 32, 2048)])


def _attn_ref(q, k, v):
    return ref.attention(q, k, v, causal=True)


def _attn_heuristic(q, k, v):
    return {"q_chunk": 512, "k_chunk": 1024}      # RunConfig's defaults


def _attn_chunks_example():
    rs = np.random.RandomState(0)
    mk = lambda *s: torch.from_numpy((rs.randn(*s) * 0.3).astype(np.float32))
    return (mk(1, 4, 64, 16), mk(1, 2, 64, 16), mk(1, 2, 64, 16)), {}


@tunable("attn_chunks", space=ATTN_CHUNK_SPACE, reference=_attn_ref, heuristic=_attn_heuristic,
         dispatch=DispatchSpec(example=_attn_chunks_example, data_parallel_args=(0, 1, 2)))
def attention_chunked(q, k, v, *, q_chunk: int, k_chunk: int):
    return chunked_attention(q, k, v, causal=True, q_chunk=q_chunk, k_chunk=k_chunk)


MAMBA_CHUNK_SPACE = ParamSpace([PowerOfTwoParam("chunk", 4, 512)])


def make_mamba_tunable(params):
    """The ``mamba_chunk`` tunable of one Mamba mixer's ``params``, with the
    signature ``(x, *, chunk)``: ``mamba_forward`` with the chunked scan at
    ``chunk`` steps; its reference runs the whole sequence as one chunk."""
    from ..kernels.ssm_scan import ssm_scan_chunked

    def ref_fn(x):
        return ssm.mamba_forward(params, x,
                                 scan_fn=functools.partial(ssm_scan_chunked, chunk=x.shape[1]))

    @tunable("mamba_chunk", space=MAMBA_CHUNK_SPACE, reference=ref_fn, default={"chunk": 32})
    def mamba_chunked(x, *, chunk: int):
        return ssm.mamba_forward(params, x,
                                 scan_fn=functools.partial(ssm_scan_chunked, chunk=chunk))

    return mamba_chunked


XENT_CHUNK_SPACE = ParamSpace([PowerOfTwoParam("loss_chunk", 32, 4096)])


def make_xent_tunable(lm_head_w):
    """The ``xent_chunk`` tunable of one unembed weight ``[d, vocab]``, with
    the signature ``(x, labels, *, loss_chunk)``: the mean cross entropy of
    ``lm.loss_fn``'s chunked loss; its reference takes the full-vocabulary
    logits of every row at once."""

    def ref_fn(x, labels):
        logits = ref.matmul(x.reshape(-1, x.shape[-1]), lm_head_w)
        return ref.softmax_xent(logits, labels.reshape(-1)).mean()

    @tunable("xent_chunk", space=XENT_CHUNK_SPACE, reference=ref_fn,
             default={"loss_chunk": 512})
    def xent_chunked(x, labels, *, loss_chunk: int):
        from .lm import _chunked_xent

        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        return _chunked_xent({"w": lm_head_w}, x, labels, mask, loss_chunk)

    return xent_chunked
