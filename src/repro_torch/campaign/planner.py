"""Workload planner: deployment scenarios -> concrete tuning jobs.

A tuning job is (kernel x argument shapes x dtype x key extra), the
granularity of one database record. The port of ``repro.campaign.planner``
for the archs the port runs, with the same jobs, keys, weights and
scenario names (but for serving's windowed flash jobs, below):

* :func:`plan_training_jobs` -- every dispatch site of one rank's
  training step, forward and backward: the projections and FFN gemms with
  their two transposed-operand gradients, the fused FFN activation site,
  the norms and their ``rmsnorm_bwd``, the chunked loss's unembed gemms,
  ``softmax_xent`` and ``softmax_xent_bwd``, causal flash attention and its
  backward; a hybrid arch adds its Mamba layers' projections (``dt_proj``
  and ``out_proj`` in fp32) with ``ssm_scan`` and ``ssm_scan_bwd``, and
  xLSTM its mLSTM projections (``out_proj`` in fp32) and its sLSTM gate
  stack and GeGLU MLP gemms, all ``matmul`` sites;
* :func:`plan_train_jobs` -- the shorter shape-level roster (forward sites
  only, with the model-level ``attn_chunks`` site);
* :func:`plan_serving_jobs` -- every slot-pool bucket a continuous
  :class:`~repro_torch.serving.engine.ServingEngine` runs: batch-1
  admission prefills at each power-of-two sequence bucket and the decode
  pool at the full slot width, with the fused final-norm -> unembed site,
  flash attention at each distinct window, and the ``attn_chunks`` sites (each prefill, and one decode-shaped
  lookup at the pool's full depth); a hybrid arch adds its Mamba layers'
  projections with the ``ssm_scan`` site at each prefill bucket and the
  ``ssm_update`` site in the pool, xLSTM its mLSTM and sLSTM gemms at each
  bucket and in the pool, and an MoE arch its ``expert_gemm`` sites at
  each bucket's capacity.

MoE layers add their grouped ``expert_gemm`` sites keyed on (experts x
capacity x hidden), with the two transposed-operand gradients in training,
as the JAX planner does. The planner evaluates nothing. Leading (token)
dims are capped by ``max_tokens``; its default admits the 8,192-token step
of the one-card trainer (batch 4 x 2048), whose sites the JAX default of
4,096 would cap into keys the step never looks up.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..configs.base import SHAPES, ArchConfig, ShapeSpec, get_config
from ..core.database import make_key, shape_bucket
from ..core.tuner import promoted_dtype
from ..distributed.sharding import data_parallel_degree
from ..launch.defaults import default_layout, default_run
from ..models.moe import expert_capacity
from ..models.ssm import slstm_ff
from ..models.transformer import MIXERS, RunConfig

# The tunables a campaign tunes by default, as in the JAX planner: the
# dispatch sites (``attn_chunks`` being the model-level chunked attention),
# the *_bwd ones being the backward plane (matmul and expert_gemm gradients
# reuse their forward tunables). A record for a fused site is what opts the
# site into fusion.
DEFAULT_KERNELS = (
    "matmul",
    "rmsnorm",
    "flash_attention",
    "softmax_xent",
    "attn_chunks",
    "ssm_scan",
    "ssm_update",
    "expert_gemm",
    "rmsnorm_bwd",
    "flash_attention_bwd",
    "softmax_xent_bwd",
    "ssm_scan_bwd",
    "ssm_update_bwd",
    "matmul_bias_act",
    "rmsnorm_matmul",
)

MAX_TOKENS = 8192
F32 = "float32"

_ACT_OF_FFN = {"swiglu": "silu", "geglu": "gelu", "gelu": "gelu"}


def _register_tunables() -> None:
    from ..core.runtime import ensure_registered

    ensure_registered()


@dataclasses.dataclass
class TuningJob:
    """One schedulable unit of tuning work and its execution state."""

    kernel: str                                   # tunable registry name
    arg_shapes: Tuple[Tuple[int, ...], ...]       # tensors to materialize
    arg_dtypes: Tuple[str, ...]                   # one dtype per arg (JAX spelling)
    key_extra: str = ""                           # e.g. flash attention's "cTruew0"
    scenarios: Tuple[str, ...] = ()               # provenance, e.g. "qwen2_0_5b/train_2k@dp1"
    weight: float = 1.0                           # executions of this site per step
    # set by the scheduler
    priority: float = 0.0                         # roofline seconds at stake per step
    budget: int = 0                               # search evaluations allotted
    # set by the runner (persisted in the manifest, so a run resumes)
    status: str = "pending"                       # pending | done | poisoned
    attempts: int = 0
    evaluations: int = 0
    best_objective: float = 0.0
    default_objective: float = 0.0
    seeded: bool = False                          # warm-started from a neighbour
    error: str = ""

    def db_key(self, platform: str) -> str:
        """The key ``tuner._args_key`` gives the call: every shape and the
        promoted dtype of every arg."""
        return make_key(self.kernel, platform, self.arg_shapes,
                        promoted_dtype(self.arg_dtypes), self.key_extra)

    def bucketed_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(shape_bucket(s) for s in self.arg_shapes)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TuningJob":
        d = dict(d)
        d["arg_shapes"] = tuple(tuple(int(x) for x in s) for s in d["arg_shapes"])
        d["arg_dtypes"] = tuple(d["arg_dtypes"])
        d["scenarios"] = tuple(d.get("scenarios", ()))
        return TuningJob(**d)


def _adder(jobs: List[TuningJob], kernels: Sequence[str]):
    def add(kernel, shapes, dtypes, weight, scen, extra=""):
        if kernel in kernels and weight > 0:
            jobs.append(TuningJob(
                kernel=kernel,
                arg_shapes=tuple(tuple(int(x) for x in s) for s in shapes),
                arg_dtypes=tuple(dtypes),
                key_extra=extra,
                scenarios=(scen,),
                weight=float(weight),
            ))
    return add


def _site_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Per-step executions of each site family: attention, Mamba, mLSTM and
    sLSTM mixers, dense FFNs, MoE FFNs, layers, and norms (pre-mixer, and
    pre-FFN where the layer has one), plus each distinct attention
    window."""
    n = {m: 0.0 for m in MIXERS}
    n_ffn = n_moe = n_norm = 0.0
    windows: Dict[int, float] = {}
    for seg in cfg.segments():
        for spec in seg.pattern:
            n[spec.mixer] += seg.repeats
            if spec.mixer == "attn":
                windows[spec.window] = windows.get(spec.window, 0.0) + seg.repeats
            n_norm += seg.repeats
            if spec.ffn != "none":
                n_norm += seg.repeats
            if spec.ffn in ("dense", "moe+dense"):
                n_ffn += seg.repeats
            if "moe" in spec.ffn:
                n_moe += seg.repeats
    return {**n, "ffn": n_ffn, "moe": n_moe, "norm": n_norm, "layers": sum(n.values()),
            "windows": windows}


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """``expert_capacity`` of an MoE layer of ``cfg`` over ``n_tokens``."""
    return expert_capacity(n_tokens, cfg.num_experts, cfg.experts_per_token,
                           cfg.capacity_factor)


def _mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, d_state, dt_rank) as ``ssm.mamba_init`` derives them."""
    return cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state, max(1, -(-cfg.d_model // 16))


def plan_train_jobs(
    cfg: ArchConfig,
    shape: ShapeSpec,
    kernels: Sequence[str] = DEFAULT_KERNELS,
    max_tokens: int = MAX_TOKENS,
    max_seq: int = 4096,
) -> List[TuningJob]:
    """The shape-level forward roster of one (arch x train/prefill shape)."""
    _register_tunables()
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.num_heads, cfg.num_kv_heads
    f = cfg.dtype
    scen = f"{cfg.name}/{shape.name}"
    B, S = shape.global_batch, shape.seq_len
    T = max(1, min(max_tokens, B * S))
    counts = _site_counts(cfg)
    jobs: List[TuningJob] = []
    add = _adder(jobs, kernels)

    add("matmul", [(T, d), (d, H * hd)], [f, f], counts["attn"], scen)
    if cfg.d_ff > 0:
        add("matmul", [(T, d), (d, cfg.d_ff)], [f, f], counts["ffn"], scen)
    # The JAX roster counts two norms a layer whatever its FFN.
    add("rmsnorm", [(T, d), (d,)], [f, f], 2 * counts["layers"], scen)
    if shape.kind == "train":
        add("softmax_xent", [(T, cfg.vocab_size), (T,)], [f, "int32"], 1.0, scen)
    s_att = max(1, min(S, max_seq))
    b_att = max(1, min(B, max_tokens // s_att))
    q = (b_att, H, s_att, hd)
    kv = (b_att, KV, s_att, hd)
    add("flash_attention", [q, kv, kv], [f, f, f], counts["attn"], scen, extra="cTruew0")
    add("attn_chunks", [q, kv, kv], [f, f, f], counts["attn"], scen)
    # Mamba: the projections at token rows and the batch-shaped scan
    n_mamba = counts["mamba"]
    if n_mamba > 0:
        di, ds, dtr = _mamba_dims(cfg)
        add("matmul", [(T, d), (d, 2 * di)], [f, f], n_mamba, scen)
        add("matmul", [(T, di), (di, dtr + 2 * ds)], [f, f], n_mamba, scen)
        add("matmul", [(T, dtr), (dtr, di)], [F32, F32], n_mamba, scen)
        add("matmul", [(T, di), (di, d)], [F32, F32], n_mamba, scen)
        add("ssm_scan", [(b_att, s_att, di), (b_att, s_att, di), (b_att, s_att, ds),
                         (b_att, s_att, ds), (di, ds), (b_att, di, ds)],
            [f, F32, F32, F32, F32, F32], n_mamba, scen)
    # xLSTM: the mLSTM's projections (out_proj in fp32) and the sLSTM's gate
    # stack and MLP, at token rows
    if counts["mlstm"] > 0:
        di = 2 * d
        add("matmul", [(T, d), (d, 2 * di)], [f, f], counts["mlstm"], scen)
        add("matmul", [(T, di), (di, di)], [f, f], 3 * counts["mlstm"], scen)
        add("matmul", [(T, di), (di, d)], [F32, F32], counts["mlstm"], scen)
    if counts["slstm"] > 0:
        ffs = slstm_ff(d)
        add("matmul", [(T, d), (d, 4 * d)], [f, f], counts["slstm"], scen)
        add("matmul", [(T, d), (d, ffs)], [f, f], 2 * counts["slstm"], scen)
        add("matmul", [(T, ffs), (ffs, d)], [f, f], counts["slstm"], scen)
    # MoE expert FFN: capacity from the step's whole token count, capped
    if counts["moe"] > 0:
        e, cap = cfg.num_experts, min(max_tokens, _capacity(cfg, B * S))
        n_up = 2 if cfg.ffn_kind in ("swiglu", "geglu") else 1
        add("expert_gemm", [(e, cap, d), (e, d, cfg.d_ff)], [f, f], n_up * counts["moe"], scen)
        add("expert_gemm", [(e, cap, cfg.d_ff), (e, cfg.d_ff, d)], [f, f], counts["moe"], scen)
    return jobs


def _parse_mesh_axes(mesh_axes) -> Dict[str, int]:
    """Accept {"data": 2, "model": 4}, "2x4", or "2x16x16" (pod first)."""
    if mesh_axes is None:
        return {}
    if isinstance(mesh_axes, str):
        from ..launch.mesh import parse_mesh_spec

        dims, names = parse_mesh_spec(mesh_axes)
        return dict(zip(names, dims))
    return {k: int(v) for k, v in dict(mesh_axes).items()}


def _rank_widths(cfg: ArchConfig, sizes: Dict[str, int], layout) -> Dict[str, Any]:
    """The widths one rank dispatches on a mesh of ``sizes`` under
    ``layout`` (``tensor_parallel.rank_widths``, the global widths with no
    tensor axis), and the scenario tag of its tensor axis."""
    from ..distributed import tensor_parallel as tp

    layout = layout if layout is not None else default_layout(cfg)
    t = tp.tensor_size(sizes, layout) if sizes else 1
    w = tp.rank_widths(cfg, sizes if t > 1 else {}, layout)
    w["tag"] = f"@tp{t}" if t > 1 else ""
    # a row-parallel product's key: fp32 out (models/layers.py:row_parallel)
    w["row"] = "o32" if t > 1 else ""
    return w


def plan_training_jobs(
    cfg: ArchConfig,
    shape: ShapeSpec,
    layout=None,
    mesh_axes=None,
    run: Optional[RunConfig] = None,
    kernels: Sequence[str] = DEFAULT_KERNELS,
    max_tokens: int = MAX_TOKENS,
    max_seq: int = 4096,
) -> List[TuningJob]:
    """Every dispatch site of the training step, forward and backward, at
    the shapes one rank looks up.

    ``mesh_axes`` (an axis -> size map or a "DATAxMODEL" spec; no process
    group needed) and ``layout`` (default ``launch.defaults.default_layout``)
    give the step's data-parallel degree, as JAX's planner computes it:
    from the microbatch's global batch. A data-parallel rank of the Trainer
    runs its share of each microbatch's rows, so the planned rows are the
    rank's; the scenarios read ``@dp{degree}``, ``@dp1`` with no mesh. A
    tensor axis of t > 1 ranks plans the widths a rank dispatches
    (``tensor_parallel.rank_widths``): the column-parallel gemms' ``n`` and
    the row-parallel ones' ``k`` over t (their forward keyed ``o32``, the
    fp32-out product), flash at the rank's heads, the unembed and both cross
    entropy kernels at ``vocab / t``; the scenarios add ``@tp{t}``.

    Each gemm site adds its two gradients, dL/dx = ct[m,n] @ wT[n,k] and
    dL/dw = xT[k,m] @ ct[m,n]; each norm, loss and attention site adds its
    ``*_bwd`` tunable with the forward's saved residuals as keyed operands
    (inverse rms, lse, attention output and lse). The FFN's activation
    up-projection adds the fused ``matmul_bias_act`` candidate (zero bias,
    the activation in the key), whose backward runs on the gemm jobs.
    ``run`` supplies ``microbatches`` and ``loss_chunk`` (default: the
    launcher's for this shape).
    """
    _register_tunables()
    run = run if run is not None else default_run(cfg, shape)
    sizes = _parse_mesh_axes(mesh_axes)
    layout = layout if layout is not None else default_layout(cfg)
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.num_heads, cfg.num_kv_heads
    f = cfg.dtype
    B, S = shape.global_batch, shape.seq_len
    b_mb = max(1, B // max(1, int(run.microbatches)))     # per-microbatch global batch
    dp = data_parallel_degree(sizes, layout, b_mb) if sizes else 1
    b_loc = max(1, b_mb // dp)                            # a rank's rows of it
    rw = _rank_widths(cfg, sizes, layout)
    scen = f"{cfg.name}/{shape.name}@dp{dp}" + rw["tag"]
    s = min(S, max_seq)
    T = min(b_loc * s, max_tokens)
    counts = _site_counts(cfg)
    n_attn, n_ffn, n_norm = counts["attn"], counts["ffn"], counts["norm"]
    jobs: List[TuningJob] = []
    add = _adder(jobs, kernels)

    def add_gemm(m, kdim, n, weight, dtype=f, extra=""):
        add("matmul", [(m, kdim), (kdim, n)], [dtype, dtype], weight, scen, extra=extra)
        add("matmul", [(m, n), (n, kdim)], [dtype, dtype], weight, scen)     # dL/dx
        add("matmul", [(kdim, m), (m, n)], [dtype, dtype], weight, scen)     # dL/dw

    def add_egemm(e, c, kdim, n, weight):
        """An expert_gemm site and its two gradients, dL/dx = ct[e,c,n] @
        wT[e,n,k] and dL/dw = xT[e,k,c] @ ct[e,c,n] (``_expert_gemm_bwd``)."""
        add("expert_gemm", [(e, c, kdim), (e, kdim, n)], [f, f], weight, scen)
        add("expert_gemm", [(e, c, n), (e, n, kdim)], [f, f], weight, scen)
        add("expert_gemm", [(e, kdim, c), (e, c, n)], [f, f], weight, scen)

    add_gemm(T, d, rw["q"], n_attn)                                  # q proj
    add_gemm(T, d, rw["kv"], 2 * n_attn)                             # k, v proj
    add_gemm(T, rw["o"], d, n_attn, extra=rw["row"])                 # o proj
    if cfg.d_ff > 0 and n_ffn > 0:
        n_up = 2 if cfg.ffn_kind in ("swiglu", "geglu") else 1
        ff = rw["ff"]
        add_gemm(T, d, ff, n_up * n_ffn)
        add_gemm(T, ff, d, n_ffn, extra=rw["row"])
        act = _ACT_OF_FFN.get(cfg.ffn_kind)
        if act:
            add("matmul_bias_act", [(T, d), (d, ff), (ff,)], [f, f, f], n_ffn,
                scen, extra=f"a{act}")
    # Norm rows: the layers' norms and the final norm, with the backward's
    # cotangent, x, weight and the saved per-row fp32 inverse rms.
    add("rmsnorm", [(T, d), (d,)], [f, f], n_norm + 1, scen)
    add("rmsnorm_bwd", [(T, d), (T, d), (d,), (T,)], [f, f, f, "float32"], n_norm + 1, scen)
    if shape.kind == "train":
        chunk = max(1, min(int(run.loss_chunk), s))
        rows = min(b_loc * chunk, max_tokens)
        n_chunks = max(1.0, s / chunk)
        vocab = rw["vocab"]
        add_gemm(rows, d, vocab, n_chunks)
        add("softmax_xent", [(rows, vocab), (rows,)], [f, "int32"], n_chunks, scen)
        add("softmax_xent_bwd", [(rows,), (rows, vocab), (rows,), (rows,)],
            ["float32", f, "int32", "float32"], n_chunks, scen)
    b_att = max(1, min(b_loc, max_tokens // max(1, s)))
    q = (b_att, rw["heads"], s, hd)
    kv = (b_att, rw["kv_heads"], s, hd)
    lse_s = (b_att, rw["heads"], s)
    for w, n in sorted(counts["windows"].items()):
        add("flash_attention", [q, kv, kv], [f, f, f], n, scen, extra=f"cTruew{w}")
        add("flash_attention_bwd", [q, q, kv, kv, q, lse_s], [f, f, f, f, f, "float32"], n,
            scen, extra=f"cTruew{w}")
    # Mamba: the four projections (dt_proj and out_proj in fp32) with their
    # gradients, the scan at the attention's batch and its backward, whose
    # two fp32 cotangents take the shapes of y and of the final state
    n_mamba = counts["mamba"]
    if n_mamba > 0:
        di, ds, dtr = _mamba_dims(cfg)
        add_gemm(T, d, 2 * di, n_mamba)                               # in_proj
        add_gemm(T, di, dtr + 2 * ds, n_mamba)                        # x_proj
        add_gemm(T, dtr, di, n_mamba, dtype=F32)                      # dt_proj
        add_gemm(T, di, d, n_mamba, dtype=F32)                        # out_proj
        xc_s, bc_s, a_s, h_s = (b_att, s, di), (b_att, s, ds), (di, ds), (b_att, di, ds)
        add("ssm_scan", [xc_s, xc_s, bc_s, bc_s, a_s, h_s], [f, F32, F32, F32, F32, F32],
            n_mamba, scen)
        add("ssm_scan_bwd", [xc_s, h_s, xc_s, xc_s, bc_s, bc_s, a_s, h_s],
            [F32, F32, f, F32, F32, F32, F32, F32], n_mamba, scen)
    # xLSTM: the mLSTM's and sLSTM's gemms with their gradients (the
    # recurrences and the mLSTM's gate projection are plain torch)
    if counts["mlstm"] > 0:
        di = 2 * d
        add_gemm(T, d, 2 * di, counts["mlstm"])                       # in_proj
        add_gemm(T, di, di, 3 * counts["mlstm"])                      # wq/wk/wv
        add_gemm(T, di, d, counts["mlstm"], dtype=F32)                # out_proj
    if counts["slstm"] > 0:
        ffs = slstm_ff(d)
        add_gemm(T, d, 4 * d, counts["slstm"])                        # gate stack
        add_gemm(T, d, ffs, 2 * counts["slstm"])                      # up_g/up_u
        add_gemm(T, ffs, d, counts["slstm"])                          # down
    # MoE expert FFN: capacity from the microbatch's whole token count
    # (expert_gemm args are not batch-sharded), capped like every leading dim
    if counts["moe"] > 0:
        e, cap = cfg.num_experts, min(max_tokens, _capacity(cfg, b_loc * S))
        n_up = 2 if cfg.ffn_kind in ("swiglu", "geglu") else 1
        add_egemm(e, cap, d, cfg.d_ff, n_up * counts["moe"])          # wg/wu
        add_egemm(e, cap, cfg.d_ff, d, counts["moe"])                 # wd
    return jobs


def _seq_buckets(max_seq: int, min_seq: int = 16) -> List[int]:
    seqs: List[int] = []
    s = min_seq
    while s < max_seq:
        seqs.append(s)
        s <<= 1
    seqs.append(shape_bucket((max_seq,))[0])
    return sorted(set(seqs))


def serving_buckets(max_batch: int, max_seq: int, min_seq: int = 16) -> List[Tuple[int, int]]:
    """The (batch, seq bucket) pairs a slot-pool engine runs: batch-1
    admission prefills and the full-width decode pool at each bucket."""
    seqs = _seq_buckets(max_seq, min_seq)
    return sorted({(1, s) for s in seqs} | {(max_batch, s) for s in seqs})


def plan_serving_jobs(
    cfg: ArchConfig,
    max_batch: int = 8,
    max_seq: int = 256,
    kernels: Sequence[str] = DEFAULT_KERNELS,
    max_tokens: int = MAX_TOKENS,
    mesh_axes=None,
    layout=None,
) -> List[TuningJob]:
    """Kernel jobs for every slot-pool bucket a ServingEngine runs.

    Admission prefills run at batch 1 x seq bucket (s token rows, causal
    attention over [1, H, s, hd], the unembed of the last real position at
    one row); the decode pool runs every tick at ``max_batch`` rows, with
    the fused final-norm -> unembed candidate, weighted by the s ticks a
    request spends at that depth. Prefill's flash attention is planned once
    for each distinct window of the layer pattern, as in training: the JAX
    planner plans ``cTruew0`` alone, a key a windowed layer never looks up.
    An arch with a frontend is not served (the engine refuses it), so it
    plans nothing, as in JAX. ``mesh_axes`` (a size map or a "DATAxMODEL"
    spec) and ``layout`` plan the widths a rank of a tensor axis
    dispatches, as :func:`plan_training_jobs` does; the scenarios add
    ``@tp{t}``.
    """
    if cfg.frontend is not None:
        return []
    _register_tunables()
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.num_heads, cfg.num_kv_heads
    f = cfg.dtype
    counts = _site_counts(cfg)
    n_attn, n_ffn, n_mamba, n_moe = counts["attn"], counts["ffn"], counts["mamba"], counts["moe"]
    n_mlstm, n_slstm, ffs = counts["mlstm"], counts["slstm"], slstm_ff(d)
    n_norm = 2 * counts["layers"]         # JAX's serving roster: two norms a layer
    di, ds, dtr = _mamba_dims(cfg)
    e = cfg.num_experts
    n_up = 2 if cfg.ffn_kind in ("swiglu", "geglu") else 1
    jobs: List[TuningJob] = []
    add = _adder(jobs, kernels)
    B = max_batch
    rw = _rank_widths(cfg, _parse_mesh_axes(mesh_axes), layout)
    qw, kvw, ow, ffw, V = rw["q"], rw["kv"], rw["o"], rw["ff"], rw["vocab"]
    H, KV = rw["heads"], rw["kv_heads"]
    for s in _seq_buckets(max_seq):
        if s <= max_tokens:
            scen = f"{cfg.name}/serve_prefill_b1s{s}" + rw["tag"]
            add("matmul", [(s, d), (d, qw)], [f, f], n_attn, scen)
            add("matmul", [(s, d), (d, kvw)], [f, f], 2 * n_attn, scen)
            add("matmul", [(s, ow), (ow, d)], [f, f], n_attn, scen, extra=rw["row"])
            if cfg.d_ff > 0:
                add("matmul", [(s, d), (d, ffw)], [f, f], n_up * n_ffn, scen)
                add("matmul", [(s, ffw), (ffw, d)], [f, f], n_ffn, scen, extra=rw["row"])
            add("matmul", [(1, d), (d, V)], [f, f], 1.0, scen)
            add("rmsnorm", [(s, d), (d,)], [f, f], n_norm, scen)
            q, kv = (1, H, s, hd), (1, KV, s, hd)
            for w, n in sorted(counts["windows"].items()):
                add("flash_attention", [q, kv, kv], [f, f, f], n, scen, extra=f"cTruew{w}")
            add("attn_chunks", [q, kv, kv], [f, f, f], n_attn, scen)
            # Mamba at prefill: the projections over s rows, dt_proj and
            # out_proj in fp32, and the batch-1 scan
            add("matmul", [(s, d), (d, 2 * di)], [f, f], n_mamba, scen)
            add("matmul", [(s, di), (di, dtr + 2 * ds)], [f, f], n_mamba, scen)
            add("matmul", [(s, dtr), (dtr, di)], [F32, F32], n_mamba, scen)
            add("matmul", [(s, di), (di, d)], [F32, F32], n_mamba, scen)
            add("ssm_scan", [(1, s, di), (1, s, di), (1, s, ds), (1, s, ds), (di, ds),
                             (1, di, ds)], [f, F32, F32, F32, F32, F32], n_mamba, scen)
            # xLSTM at prefill: the projections over s rows
            add("matmul", [(s, d), (d, 4 * d)], [f, f], n_mlstm, scen)
            add("matmul", [(s, 2 * d), (2 * d, 2 * d)], [f, f], 3 * n_mlstm, scen)
            add("matmul", [(s, 2 * d), (2 * d, d)], [F32, F32], n_mlstm, scen)
            add("matmul", [(s, d), (d, 4 * d)], [f, f], n_slstm, scen)
            add("matmul", [(s, d), (d, ffs)], [f, f], 2 * n_slstm, scen)
            add("matmul", [(s, ffs), (ffs, d)], [f, f], n_slstm, scen)
            # MoE at prefill: the bucket's s tokens set the capacity
            cap = _capacity(cfg, s) if n_moe else 0
            add("expert_gemm", [(e, cap, d), (e, d, cfg.d_ff)], [f, f], n_up * n_moe, scen)
            add("expert_gemm", [(e, cap, cfg.d_ff), (e, cfg.d_ff, d)], [f, f], n_moe, scen)
        if B * s > max_tokens:
            continue
        scen = f"{cfg.name}/serve_decode_b{B}s{s}" + rw["tag"]
        add("matmul", [(B, d), (d, qw)], [f, f], n_attn * s, scen)
        add("matmul", [(B, d), (d, kvw)], [f, f], 2 * n_attn * s, scen)
        add("matmul", [(B, ow), (ow, d)], [f, f], n_attn * s, scen, extra=rw["row"])
        if cfg.d_ff > 0:
            add("matmul", [(B, d), (d, ffw)], [f, f], n_up * n_ffn * s, scen)
            add("matmul", [(B, ffw), (ffw, d)], [f, f], n_ffn * s, scen, extra=rw["row"])
        add("matmul", [(B, d), (d, V)], [f, f], float(s), scen)
        add("rmsnorm", [(B, d), (d,)], [f, f], n_norm * s, scen)
        add("rmsnorm_matmul", [(B, d), (d,), (d, V)], [f, f, f], float(s), scen)
        # Mamba in the pool: the projections at B rows and one ssm_update
        add("matmul", [(B, d), (d, 2 * di)], [f, f], n_mamba * s, scen)
        add("matmul", [(B, di), (di, dtr + 2 * ds)], [f, f], n_mamba * s, scen)
        add("matmul", [(B, dtr), (dtr, di)], [F32, F32], n_mamba * s, scen)
        add("matmul", [(B, di), (di, d)], [F32, F32], n_mamba * s, scen)
        add("ssm_update", [(B, di), (B, di), (B, ds), (B, ds), (di, ds), (B, di, ds)],
            [f, F32, F32, F32, F32, F32], n_mamba * s, scen)
        # xLSTM in the pool: the projections at B rows
        add("matmul", [(B, d), (d, 4 * d)], [f, f], n_mlstm * s, scen)
        add("matmul", [(B, 2 * d), (2 * d, 2 * d)], [f, f], 3 * n_mlstm * s, scen)
        add("matmul", [(B, 2 * d), (2 * d, d)], [F32, F32], n_mlstm * s, scen)
        add("matmul", [(B, d), (d, 4 * d)], [f, f], n_slstm * s, scen)
        add("matmul", [(B, d), (d, ffs)], [f, f], 2 * n_slstm * s, scen)
        add("matmul", [(B, ffs), (ffs, d)], [f, f], n_slstm * s, scen)
        # MoE in the pool: the B slots (free ones included) set the capacity
        cap = _capacity(cfg, B) if n_moe else 0
        add("expert_gemm", [(e, cap, d), (e, d, cfg.d_ff)], [f, f], n_up * n_moe * s, scen)
        add("expert_gemm", [(e, cap, cfg.d_ff), (e, cfg.d_ff, d)], [f, f], n_moe * s, scen)
    # the plain path's decode attention: one query row against the pool's
    # cache, which is allocated at the full depth once
    s_max = _seq_buckets(max_seq)[-1]
    if B * s_max <= max_tokens:
        add("attn_chunks", [(B, H, 1, hd), (B, KV, s_max, hd), (B, KV, s_max, hd)], [f, f, f],
            n_attn * s_max, f"{cfg.name}/serve_decode_b{B}s{s_max}" + rw["tag"])
    return jobs


def plan_jobs(
    arch_names: Sequence[str],
    train_shapes: Sequence[str] = ("train_2k",),
    serving: Optional[Tuple[int, int]] = (8, 2048),
    kernels: Sequence[str] = DEFAULT_KERNELS,
    reduced: bool = False,
    max_tokens: int = MAX_TOKENS,
    max_seq: int = 4096,
    run: Optional[RunConfig] = None,
    train_mesh=None,
    serving_mesh=None,
) -> List[TuningJob]:
    """The whole campaign workload, in a fixed order: each arch's training
    step (every dispatch site, forward and backward) for each train shape
    and, with ``serving=(max_batch, max_seq)``, its serving buckets.
    ``reduced`` plans the small smoke configs; ``train_mesh`` (an axis ->
    size map or a "DATAxMODEL" spec) plans the training step of one rank on
    that mesh under each arch's ``default_layout``, ``serving_mesh`` the
    serving buckets of one rank of a tensor axis."""
    _register_tunables()
    jobs: List[TuningJob] = []
    for name in arch_names:
        cfg = get_config(name)
        if reduced:
            cfg = cfg.reduced()
        for shape_name in train_shapes:
            jobs.extend(plan_training_jobs(cfg, SHAPES[shape_name], mesh_axes=train_mesh,
                                           run=run, kernels=kernels, max_tokens=max_tokens,
                                           max_seq=max_seq))
        if serving is not None:
            jobs.extend(plan_serving_jobs(cfg, serving[0], serving[1], kernels=kernels,
                                          max_tokens=max_tokens, mesh_axes=serving_mesh))
    jobs.sort(key=lambda j: (j.kernel, j.arg_shapes, j.key_extra, j.scenarios))
    return jobs
