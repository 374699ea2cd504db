"""Database keys for tunable calls.

Only the key function is ported so far; the tuner loop (search, wall-clock
evaluation behind the correctness gate) comes with the training slice.

Keys must read exactly as the JAX package writes them, so dtypes are
spelled the JAX way (``bfloat16``, never ``torch.bfloat16``) and the key
dtype is the promotion of every array argument's dtype by JAX's rules.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import torch

from .annotate import Tunable
from .database import make_key

_JAX_NAMES = {
    torch.float32: "float32",
    torch.float64: "float64",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int8: "int8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.uint8: "uint8",
    torch.bool: "bool",
}


def dtype_name(dtype: torch.dtype) -> str:
    """JAX's spelling of a torch dtype (``torch.bfloat16`` -> ``bfloat16``)."""
    try:
        return _JAX_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no JAX dtype name for {dtype}") from None


@functools.lru_cache(maxsize=512)
def _promote(dtypes: tuple) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        # torch's promotion agrees with JAX's on the types the port keys:
        # bf16 x f32 -> f32, bf16 x f16 -> f32, int32 x f32 -> f32,
        # int32 x bf16 -> bf16.
        out = torch.promote_types(out, d)
    return out


def promoted_dtype(dtypes: Sequence[torch.dtype]) -> str:
    """Order-independent key dtype: the promotion of all array dtypes."""
    if not dtypes:
        return "f32"
    return dtype_name(_promote(tuple(dtypes)))


def _args_key(tunable: Tunable, args: Sequence[Any], platform: str,
              extra: str = "") -> str:
    """Database key for (tunable, tensor args) on ``platform``."""
    shapes, dtypes = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            shapes.append(tuple(a.shape))
            dtypes.append(a.dtype)
    return make_key(tunable.name, platform, shapes, promoted_dtype(dtypes), extra)


def first_device(args: Sequence[Any]) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None
