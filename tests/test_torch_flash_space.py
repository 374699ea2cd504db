"""The flash kernels' knob spaces on the CPU: every config fits one H100
block up to d = 128, on the bf16 tensor-core route and on the fp32 SIMT
route (which maps every config to its own tiles); at d = 256 the legality
checks admit only the configs that fit, the tuner prunes the others before
a trial, no tier resolves to one and the wrappers refuse them; each
heuristic is legal at every shape of the main paths; a database record
written for the earlier SIMT-only spaces no longer resolves and falls to
the heuristic.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
from repro_torch.core import database as tdb  # noqa: E402
from repro_torch.core.platform import H100_SXM  # noqa: E402
from repro_torch.core.runtime import runtime  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402

SMEM = H100_SXM.smem_per_block       # 227 KB
D = fa.SPACE_HEAD_DIM                # every config fits up to here


def _meta(*s):
    return torch.empty(*s, device="meta")


@pytest.mark.parametrize("cfg", list(fa.ATTENTION_SPACE.enumerate()), ids=str)
def test_every_forward_config_fits_at_d128_on_both_routes(cfg):
    assert fa.smem_bytes(cfg, D) <= SMEM
    assert fa.simt_smem_bytes(fa.simt_tiles(D), D) <= SMEM


@pytest.mark.parametrize("cfg", list(fa.ATTENTION_BWD_SPACE.enumerate()), ids=str)
def test_every_backward_config_fits_at_d128_on_both_routes(cfg):
    assert fa.bwd_smem_bytes(cfg, D) <= SMEM
    assert fa.simt_bwd_smem_bytes(fa.simt_tiles(D), D) <= SMEM


def test_spaces_are_the_tensor_core_tiles():
    # 64 rows a consumer warpgroup: the SIMT spaces' 16- and 32-row q tiles
    # and 256-key tiles are gone
    assert {c["block_q"] for c in fa.ATTENTION_SPACE.enumerate()} == {64, 128}
    assert {c["block_k"] for c in fa.ATTENTION_SPACE.enumerate()} == {64, 128}
    assert {c["stages"] for c in fa.ATTENTION_SPACE.enumerate()} == {2, 3}
    assert len(list(fa.ATTENTION_SPACE.enumerate())) == 8
    assert len(list(fa.ATTENTION_BWD_SPACE.enumerate())) == 4
    # the largest forward config is legal, and one more stage is not
    assert fa.ATTENTION_SPACE.is_valid({"block_q": 128, "block_k": 128, "stages": 3})
    big = {"block_q": 128, "block_k": 128, "stages": 4}
    assert fa.smem_bytes(big, D) > SMEM


def test_simt_rule_is_the_largest_square_tile_legal_for_every_pass():
    # the one rule of the fp32 route, whatever the config: 64 x 64 up to
    # d = 128, 32 x 32 at d = 256; 128 x 128 would not fit its forward at
    # d = 128, 64 x 128 not its backward, 64 x 64 neither at d = 256
    assert fa.simt_tiles(D) == {"block_q": 64, "block_k": 64}
    assert fa.simt_tiles(256) == {"block_q": 32, "block_k": 32}
    for d in fa.HEAD_DIMS:
        t = fa.simt_tiles(d)
        assert fa.simt_smem_bytes(t, d) <= SMEM
        assert fa.simt_bwd_smem_bytes(t, d) <= SMEM
        bigger = {"block_q": 2 * t["block_q"], "block_k": 2 * t["block_k"]}
        assert max(fa.simt_smem_bytes(bigger, d), fa.simt_bwd_smem_bytes(bigger, d)) > SMEM \
            or d < 128
    assert fa.simt_smem_bytes({"block_q": 128, "block_k": 128}, D) > SMEM
    assert fa.simt_bwd_smem_bytes({"block_q": 64, "block_k": 128}, D) > SMEM
    assert fa.simt_bwd_smem_bytes({"block_q": 64, "block_k": 64}, 256) > SMEM


def _fwd_args(d, dtype=torch.bfloat16, h=8, kv=1, s=64):
    return _meta(2, h, s, d).to(dtype), _meta(2, kv, s, d).to(dtype), _meta(2, kv, s, d).to(dtype)


def _bwd_args(d, dtype=torch.bfloat16, h=8, kv=1, s=64):
    q, k, v = _fwd_args(d, dtype, h, kv, s)
    return q, q, k, v, q, _meta(2, h, s)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_every_config_the_spaces_admit_at_a_head_dim_fits_there(d):
    """What the tuner may choose at head dim d (the space's constraints and
    the tunable's legality check on the call's tensors) fits one block at d
    on the bf16 route; at d = 256 that is 64-key forward tiles (128 x 64 with
    two stages only) and 64 x 64 in the backward; fp32 admits every config,
    which its SIMT tiles run."""
    fwd = [c for c in fa.ATTENTION_SPACE.enumerate()
           if fa.flash_attention.why_illegal(c, *_fwd_args(d)) is None]
    bwd = [c for c in fa.ATTENTION_BWD_SPACE.enumerate()
           if fa.flash_attention_bwd.why_illegal(c, *_bwd_args(d)) is None]
    assert fwd and bwd
    assert all(fa.smem_bytes(c, d) <= SMEM for c in fwd)
    assert all(fa.bwd_smem_bytes(c, d) <= SMEM for c in bwd)
    # nothing that fits is pruned
    assert len(fwd) == sum(fa.smem_bytes(c, d) <= SMEM for c in fa.ATTENTION_SPACE.enumerate())
    assert len(bwd) == sum(fa.bwd_smem_bytes(c, d) <= SMEM
                           for c in fa.ATTENTION_BWD_SPACE.enumerate())
    if d <= D:
        assert len(fwd) == 8 and len(bwd) == 4
    else:
        assert fwd == [{"block_q": 64, "block_k": 64, "stages": 2},
                       {"block_q": 64, "block_k": 64, "stages": 3},
                       {"block_q": 128, "block_k": 64, "stages": 2}]
        assert bwd == [{"block_q": 64, "block_k": 64}]
    for c in fa.ATTENTION_SPACE.enumerate():
        assert fa.flash_attention.why_illegal(c, *_fwd_args(d, torch.float32)) is None
    for c in fa.ATTENTION_BWD_SPACE.enumerate():
        assert fa.flash_attention_bwd.why_illegal(c, *_bwd_args(d, torch.float32)) is None


def test_wrappers_refuse_a_config_not_legal_at_the_head_dim():
    """Before any launch (these are CPU tensors: a legal config would go on
    to build the library)."""
    q, k, v = (t.to("cpu") for t in (torch.zeros(1, 8, 64, 256, dtype=torch.bfloat16),
                                     torch.zeros(1, 1, 64, 256, dtype=torch.bfloat16),
                                     torch.zeros(1, 1, 64, 256, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="not legal at d=256"):
        fa.flash_attention_cuda(q, k, v, block_q=64, block_k=128, stages=2)
    lse = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="not legal at d=256"):
        fa.flash_attention_bwd_cuda(q, q, k, v, q, lse, block_q=128, block_k=64)


def test_the_tuner_prunes_configs_not_legal_at_d256_before_a_trial():
    """An exhaustive search at d = 256 on the CPU: the five forward configs
    that do not fit are pruned with their reason and never run; the winner
    is legal."""
    from repro_torch.core.evaluate import WallClockEvaluator
    from repro_torch.core.search import ExhaustiveSearch
    from repro_torch.core.tuner import autotune

    rs = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 16, 256, generator=rs).to(torch.bfloat16)
    k = torch.randn(1, 1, 16, 256, generator=rs).to(torch.bfloat16)
    v = torch.randn(1, 1, 16, 256, generator=rs).to(torch.bfloat16)
    ran = []
    tun = fa.flash_attention
    orig = tun.fn

    def spy(*args, **kw):
        ran.append({n: kw[n] for n in tun.space.names})
        return orig(*args, **kw)

    tun.fn = spy
    try:
        res = autotune(tun, (q, k, v), search=ExhaustiveSearch(budget=8),
                       evaluator=WallClockEvaluator(1, 0), db=tdb.TuningDatabase(None),
                       save=False, call_kwargs={"causal": True, "window": 0})
    finally:
        tun.fn = orig
    pruned = [t for t in res.search.trials if "pruned" in t.meta]
    assert len(pruned) == 5
    assert all("shared memory at d=256" in t.meta["pruned"] for t in pruned)
    assert all(fa.smem_bytes(c, 256) <= SMEM for c in ran)
    assert not any(t.config in ran for t in pruned)
    assert fa.smem_bytes(res.best_config, 256) <= SMEM


@pytest.mark.parametrize("tier", ["exact", "cover"])
def test_a_record_not_legal_at_d256_falls_to_the_heuristic(tmp_path, tier):
    """A record (or the nearest cover entry) whose tiles do not fit at the
    call's head dim resolves to nothing: the heuristic serves the call."""
    q, k, v = (torch.empty(1, 8, 24, 256, dtype=torch.bfloat16),
               torch.empty(1, 1, 24, 256, dtype=torch.bfloat16),
               torch.empty(1, 1, 24, 256, dtype=torch.bfloat16))
    big = {"block_q": 128, "block_k": 128, "stages": 3}
    path = str(tmp_path / "db.json")
    db = tdb.TuningDatabase(path)
    key = runtime(db=db).key_for(fa.flash_attention, (q, k, v), "cTruew0")
    if tier == "exact":
        db.put(tdb.Record(key=key, config=big, objective=1e-5, evaluator="wallclock",
                          evaluations=1, timestamp=tdb.now()))
    else:
        support = [[list(t.shape) for t in (q, k, v)]]
        db.put_cover("flash_attention", "torch-cpu", [{"config": big, "support": support}])
    with runtime(db=tdb.TuningDatabase(path)) as rt:
        res = rt.resolve("flash_attention", (q, k, v), key_extra="cTruew0")
    assert res.tier == "heuristic" and res.config == {"block_q": 64, "block_k": 64, "stages": 2}


# (b, h, kv, s_q, s_k, d, window): qwen2_0_5b's serving buckets and training
# step, Jamba's exact-length hybrid prefills, Mixtral's buckets with its
# window, and the s_q = 1 and s_q < s_k corners.
QWEN = [(b, 14, 2, s, s, 64, 0) for b in (1, 4)
        for s in (16, 32, 64, 128, 256, 512, 1024, 2048)]
JAMBA = [(1, 64, 8, s, s, 128, 0) for s in (16, 1500, 37, 700, 129, 1024, 300, 8, 2048)]
MIXTRAL = [(1, 32, 8, s, s, 128, 4096) for s in (16, 512, 2048, 5000, 8192)]
CORNERS = [(2, 4, 2, 1, 77, 32, 0), (2, 4, 2, 64, 128, 16, 0), (1, 32, 8, 1, 4096, 128, 4096)]
# Gemma3-27B's local and global layers at its serving buckets, PaliGemma's
# MQA heads of 256 at its training step and a ragged prefill, MusicGen's
# MHA heads of 64, Arctic's 56/8 heads of 128.
GEMMA = [(1, 32, 16, s, s, 128, w) for s in (16, 1024, 3000, 4096) for w in (0, 1024)]
PALIGEMMA = [(2, 8, 1, 2048, 2048, 256, 0), (1, 8, 1, 1000, 1000, 256, 0),
             (1, 8, 1, 1, 300, 256, 0)]
OTHERS = [(2, 32, 32, 2048, 2048, 64, 0), (1, 56, 8, 512, 512, 128, 0)]


@pytest.mark.parametrize("b,h,kv,s_q,s_k,d,window",
                         QWEN + JAMBA + MIXTRAL + CORNERS + GEMMA + PALIGEMMA + OTHERS)
def test_heuristics_are_legal_on_every_main_path_shape(b, h, kv, s_q, s_k, d, window):
    q, k = _meta(b, h, s_q, d).to(torch.bfloat16), _meta(b, kv, s_k, d).to(torch.bfloat16)
    cfg = fa._attn_heuristic(q, k, k)
    assert fa.flash_attention.why_illegal(cfg, q, k, k) is None
    assert fa.smem_bytes(cfg, d) <= SMEM
    assert fa.flash_attention.default_config(q, k, k) == cfg
    bargs = (q, q, k, k, q, _meta(b, h, s_q))
    bcfg = fa._attn_bwd_heuristic(*bargs)
    assert fa.flash_attention_bwd.why_illegal(bcfg, *bargs) is None
    assert fa.bwd_smem_bytes(bcfg, d) <= SMEM
    assert fa.flash_attention_bwd.default_config(*bargs) == bcfg


@pytest.mark.parametrize("name,old", [
    ("flash_attention", {"block_q": 32, "block_k": 128}),
    ("flash_attention_bwd", {"block_q": 64, "block_k": 32}),
])
def test_a_record_of_the_simt_spaces_falls_to_the_heuristic(tmp_path, name, old):
    q, k = torch.randn(1, 4, 24, 16), torch.randn(1, 2, 24, 16)
    o, lse = fa.flash_attention_plain(q, k, k)
    tun = getattr(fa, name)
    args = (q, k, k) if name == "flash_attention" else (q, q, k, k, o, lse)
    path = str(tmp_path / "db.json")
    db = tdb.TuningDatabase(path)
    key = runtime(db=db).key_for(tun, args, "cTruew0")
    db.put(tdb.Record(key=key, config=old, objective=1e-5, evaluator="wallclock",
                      evaluations=1, timestamp=tdb.now()))
    with runtime(db=tdb.TuningDatabase(path)) as rt:
        res = rt.resolve(name, args, key_extra="cTruew0")
    assert res.key == key and res.tier == "heuristic"
    assert res.config == tun.default_config(*args) != old
    assert rt.telemetry.snapshot()["by_key"][key] == {"heuristic": 1}
