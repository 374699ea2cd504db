"""The flash kernels' knob spaces on the CPU: every config fits one H100
block at the widest head, on the bf16 tensor-core route and on the fp32
SIMT route (which maps every config to its own tiles); each heuristic is
legal at every shape of the main paths; a database record written for the
earlier SIMT-only spaces no longer resolves and falls to the heuristic.
"""
import pytest

torch = pytest.importorskip("torch")
from repro_torch.core import database as tdb  # noqa: E402
from repro_torch.core.platform import H100_SXM  # noqa: E402
from repro_torch.core.runtime import runtime  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402

SMEM = H100_SXM.smem_per_block       # 227 KB
D = fa.MAX_HEAD_DIM


def _meta(*s):
    return torch.empty(*s, device="meta")


@pytest.mark.parametrize("cfg", list(fa.ATTENTION_SPACE.enumerate()), ids=str)
def test_every_forward_config_fits_at_d128_on_both_routes(cfg):
    assert fa.smem_bytes(cfg, D) <= SMEM
    assert fa.simt_smem_bytes(fa.SIMT_TILES, D) <= SMEM


@pytest.mark.parametrize("cfg", list(fa.ATTENTION_BWD_SPACE.enumerate()), ids=str)
def test_every_backward_config_fits_at_d128_on_both_routes(cfg):
    assert fa.bwd_smem_bytes(cfg, D) <= SMEM
    assert fa.simt_bwd_smem_bytes(fa.SIMT_TILES, D) <= SMEM


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
    # the one rule of the fp32 route: 64 x 64, whatever the config; 128 x 128
    # would not fit its forward, 64 x 128 not its backward
    assert fa.SIMT_TILES == {"block_q": 64, "block_k": 64}
    for d in fa.HEAD_DIMS:
        assert fa.simt_smem_bytes(fa.SIMT_TILES, d) <= SMEM
        assert fa.simt_bwd_smem_bytes(fa.SIMT_TILES, d) <= SMEM
    assert fa.simt_smem_bytes({"block_q": 128, "block_k": 128}, D) > SMEM
    assert fa.simt_bwd_smem_bytes({"block_q": 64, "block_k": 128}, D) > SMEM


# (b, h, kv, s_q, s_k, d, window): qwen2_0_5b's serving buckets and training
# step, Jamba's exact-length hybrid prefills, Mixtral's buckets with its
# window, and the s_q = 1 and s_q < s_k corners.
QWEN = [(b, 14, 2, s, s, 64, 0) for b in (1, 4)
        for s in (16, 32, 64, 128, 256, 512, 1024, 2048)]
JAMBA = [(1, 64, 8, s, s, 128, 0) for s in (16, 1500, 37, 700, 129, 1024, 300, 8, 2048)]
MIXTRAL = [(1, 32, 8, s, s, 128, 4096) for s in (16, 512, 2048, 5000, 8192)]
CORNERS = [(2, 4, 2, 1, 77, 32, 0), (2, 4, 2, 64, 128, 16, 0), (1, 32, 8, 1, 4096, 128, 4096)]


@pytest.mark.parametrize("b,h,kv,s_q,s_k,d,window", QWEN + JAMBA + MIXTRAL + CORNERS)
def test_heuristics_are_legal_on_every_main_path_shape(b, h, kv, s_q, s_k, d, window):
    q, k = _meta(b, h, s_q, d), _meta(b, kv, s_k, d)
    cfg = fa._attn_heuristic(q, k, k)
    assert fa.ATTENTION_SPACE.is_valid(cfg) and fa.smem_bytes(cfg, d) <= SMEM
    bcfg = fa._attn_bwd_heuristic(q, q, k, k, q, _meta(b, h, s_q))
    assert fa.ATTENTION_BWD_SPACE.is_valid(bcfg) and fa.bwd_smem_bytes(bcfg, d) <= SMEM


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
