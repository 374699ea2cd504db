"""Architecture configuration, a jax-free copy of ``repro.configs.base``.

Same :class:`ArchConfig` fields, ``segments()`` decomposition and
``reduced()`` smoke config, so one config means the same model in both
packages; ``tdtype`` returns the torch dtype where the JAX package's
``jdtype`` returns a jnp dtype. All ten of the JAX package's architectures
are registered, in its order. Jamba's dense
variant, ``dataclasses.replace(cfg, num_experts=0, experts_per_token=0)``,
is what fits one card.
``SHAPES`` holds the training shapes a campaign plans: the JAX package's
``train_4k`` and ``train_smoke``, and ``train_2k``, the one-card step
(batch 4 x 2048) the port's launcher and smoke run take.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # attn | mamba | mlstm | slstm
    window: int = 0              # 0 = full attention; >0 = sliding window
    ffn: str = "dense"           # dense | moe | moe+dense | none


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    ffn_kind: str = "swiglu"     # swiglu | geglu | gelu | relu2
    qkv_bias: bool = False
    # attention pattern
    window: int = 0                        # SWA window for swa layers
    local_global_ratio: int = 0            # k local layers per 1 global
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1                     # MoE FFN every k-th layer
    moe_residual_dense: bool = False       # arctic: dense FFN ∥ MoE
    capacity_factor: float = 1.25
    # SSM / hybrid
    attn_every: int = 0                    # jamba: attention every k-th layer
    ssm_pattern: Tuple[str, ...] = ()      # xlstm: ("mlstm", "slstm")
    mamba_expand: int = 2
    mamba_d_state: int = 16
    # frontend stubs
    frontend: Optional[str] = None         # audio_frames | vision_patches
    num_prefix: int = 0                    # paligemma: 256 patch embeddings
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    sub_quadratic: bool = False            # may run long_500k
    notes: str = ""

    # ---------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def segments(self) -> Tuple[Segment, ...]:
        """Decompose num_layers into scan-able homogeneous segments."""
        L = self.num_layers

        def ffn_for(layer_idx: int) -> str:
            if self.num_experts == 0:
                return "dense" if self.d_ff > 0 else "none"
            if (layer_idx % self.moe_every) == (self.moe_every - 1):
                return "moe+dense" if self.moe_residual_dense else "moe"
            return "dense"

        if self.ssm_pattern:  # xlstm: alternating recurrent blocks, no FFN
            pat = tuple(LayerSpec(mixer=m, ffn="none") for m in self.ssm_pattern)
            assert L % len(pat) == 0
            return (Segment(pat, L // len(pat)),)

        if self.attn_every:  # jamba: 1 attn + (attn_every-1) mamba per block
            k = self.attn_every
            assert L % k == 0
            pat = tuple(
                LayerSpec(
                    mixer=("attn" if i == 0 else "mamba"),
                    ffn=ffn_for(i),
                )
                for i in range(k)
            )
            return (Segment(pat, L // k),)

        if self.local_global_ratio:  # gemma3: 5 local : 1 global
            r = self.local_global_ratio
            blk = r + 1
            full_blocks, extra = divmod(L, blk)
            pat = tuple(
                LayerSpec(mixer="attn", window=(self.window if i < r else 0),
                          ffn=ffn_for(i))
                for i in range(blk)
            )
            segs = [Segment(pat, full_blocks)]
            if extra:
                tail = tuple(
                    LayerSpec(mixer="attn", window=self.window, ffn=ffn_for(i))
                    for i in range(extra)
                )
                segs.append(Segment(tail, 1))
            return tuple(segs)

        # homogeneous dense / moe / swa archs
        spec = LayerSpec(mixer="attn", window=self.window, ffn=ffn_for(0))
        if self.num_experts and self.moe_every > 1:
            pat = tuple(LayerSpec(mixer="attn", window=self.window, ffn=ffn_for(i))
                        for i in range(self.moe_every))
            assert L % self.moe_every == 0
            return (Segment(pat, L // self.moe_every),)
        return (Segment((spec,), L),)

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        scale = {
            "d_model": 64,
            "d_ff": 128 if self.d_ff > 0 else 0,
            "num_heads": 4,
            "num_kv_heads": max(1, min(self.num_kv_heads, 2)),
            "head_dim": 16,
            "vocab_size": 256,
            "num_experts": min(self.num_experts, 4),
            "experts_per_token": min(self.experts_per_token, 2),
            "num_prefix": min(self.num_prefix, 4),
            "window": min(self.window, 8) if self.window else 0,
        }
        # keep the layer pattern but few repeats
        seg_len = 1
        if self.ssm_pattern:
            seg_len = len(self.ssm_pattern)
        elif self.attn_every:
            seg_len = self.attn_every
        elif self.local_global_ratio:
            seg_len = self.local_global_ratio + 1
        elif self.num_experts and self.moe_every > 1:
            seg_len = self.moe_every
        layers = seg_len * 2
        return dataclasses.replace(
            self, num_layers=layers, dtype="float32", **scale
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "train_smoke": ShapeSpec("train_smoke", 64, 8, "train"),
    "train_2k": ShapeSpec("train_2k", 2_048, 4, "train"),
}


# The JAX package's registry, in its order.
ARCH_NAMES = (
    "minitron_4b",
    "qwen2_5_3b",
    "qwen2_0_5b",
    "gemma3_27b",
    "xlstm_1_3b",
    "musicgen_large",
    "arctic_480b",
    "mixtral_8x7b",
    "paligemma_3b",
    "jamba_1_5_large",
)

_ALIASES = {
    "minitron-4b": "minitron_4b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma3-27b": "gemma3_27b",
    "xlstm-1.3b": "xlstm_1_3b",
    "musicgen-large": "musicgen_large",
    "arctic-480b": "arctic_480b",
    "mixtral-8x7b": "mixtral_8x7b",
    "paligemma-3b": "paligemma_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
}

def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; the port has {list(ARCH_NAMES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
