"""Guards of the port's boundaries.

* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports jax
  or anything of the JAX package (checked on the source, by AST).
* The entry points run on the card unless told ``cpu``: on a host with no
  card they raise instead of carrying on on the CPU.
* A kernel wrapper runs its plain version only for a CPU tensor; on any
  other device it launches its kernel or raises.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import platform  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import xent as xe  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), f"{path.name} imports {mod}"


def test_scan_sees_the_whole_package():
    names = {p.name for p in SOURCES}
    assert {"runtime.py", "matmul.py", "engine.py", "serve.py", "chip_smoke.py"} <= names
    # every arch config the port registers
    assert {"qwen2_5_3b.py", "minitron_4b.py", "gemma3_27b.py", "arctic_480b.py",
            "musicgen_large.py", "paligemma_3b.py"} <= names


def test_scan_sees_the_xlstm_modules():
    """The xLSTM mixers live in models/ssm.py beside Mamba; the scan holds
    it, the xLSTM config and chip_smoke.py, which drives them on the card."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"src/repro_torch/models/ssm.py", "src/repro_torch/configs/xlstm_1_3b.py",
            "chip_smoke.py"} <= names
    text = (ROOT / "src" / "repro_torch" / "models" / "ssm.py").read_text()
    assert "def mlstm_forward(" in text and "def slstm_forward(" in text


def test_scan_sees_the_fault_and_obs_modules():
    """The fault harness and the obs plane are copies of stdlib-only JAX
    modules: the scan holds them to "no jax, no repro" like the rest."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("testing/__init__.py", "testing/faults.py", "obs/__init__.py",
                "obs/__main__.py", "obs/cli.py", "obs/collect.py", "obs/export.py",
                "obs/metrics.py", "obs/trace.py"):
        assert f"src/repro_torch/{mod}" in names
    text = (ROOT / "src" / "repro_torch" / "obs" / "trace.py").read_text()
    assert "from torch.profiler import record_function" in text


def test_scan_sees_the_resilience_modules():
    """The background tuner, the checkpointer and the recovery loop: held
    to "no jax, no ml_dtypes, no repro" like the rest (the JAX checkpointer
    restores bf16 through ml_dtypes; the port through torch)."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("core/bgtune.py", "train/checkpoint.py", "train/resilience.py"):
        assert f"src/repro_torch/{mod}" in names
    text = (ROOT / "src" / "repro_torch" / "train" / "checkpoint.py").read_text()
    assert "view(torch.int16)" in text


def test_a_default_trainer_leaves_no_checkpoint_directory(tmp_path, monkeypatch):
    """TrainerConfig keeps JAX's ``checkpoint_dir="checkpoints"``; the
    directory is made at the first save, so a trainer built with the
    defaults, as the tests build it, writes nothing where it runs."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train import Trainer, TrainerConfig

    monkeypatch.chdir(tmp_path)
    tr = Trainer(get_config("qwen2_0_5b").reduced(), RunConfig(q_chunk=8, k_chunk=8,
                                                               loss_chunk=8),
                 DataConfig(batch_size=1, seq_len=8), device="cpu")
    assert tr.tcfg.checkpoint_dir == TrainerConfig().checkpoint_dir == "checkpoints"
    tr.run_one_step()
    assert tr.ckpt.latest_step() is None
    assert not (tmp_path / "checkpoints").exists() and list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("arch", ["gemma3_27b", "paligemma_3b", "xlstm_1_3b"])
def test_the_new_archs_raise_without_a_card(no_card, arch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(get_config(arch).reduced(), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", arch, "--smoke", "--steps", "1"])


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = get_config("qwen2_0_5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"segments": ()}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2_0_5b", "--smoke"])
    assert platform.resolve_device("cpu").type == "cpu"
    assert lm.init_params(cfg, seed=0, device="cpu")["embed"]["table"].device.type == "cpu"


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--requests", "2",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 2 requests / 6 tokens on cpu" in out
    assert "tier heuristic" in out and "kernel launches: {}" in out


def test_wrappers_never_fall_back_off_the_cpu():
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        mm.matmul(meta(8, 16), meta(16, 32), bm=16, bn=64, bk=64, stages=2, splits=1)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        rn.rmsnorm(meta(8, 16), meta(16), block_rows=8)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_attention(meta(1, 4, 16, 16), meta(1, 2, 16, 16), meta(1, 2, 16, 16),
                           block_q=64, block_k=64, stages=2)


def test_platform_keys_are_namespaced_per_package():
    assert platform.detect_platform("cpu").name == "torch-cpu"
    assert platform.TORCH_CPU.name != "cpu-host"     # the JAX package's CPU key
    assert platform.H100_SXM.smem_per_block == 232_448


def test_bf16_params_cross_bit_for_bit():
    import jax.numpy as jnp

    a = np.asarray(jnp.asarray(np.random.RandomState(0).randn(5, 3), jnp.bfloat16))
    from repro_torch.convert import to_tensor

    t = to_tensor(a, torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_scan_sees_the_training_modules():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("kernels/xent.py", "optim/adamw.py", "data/pipeline.py", "train/trainer.py",
                "launch/train.py"):
        assert f"src/repro_torch/{mod}" in names


def test_train_entry_points_raise_without_a_card(no_card):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train import Trainer

    cfg = get_config("qwen2_0_5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, RunConfig(), DataConfig(batch_size=2, seq_len=8))


def test_training_wrappers_never_fall_back_off_the_cpu():
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        rn.rmsnorm_bwd(meta(8, 16), meta(8, 16), meta(16), meta(8), block_rows=8)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        xe.softmax_xent(meta(8, 300), meta(8).long(), block_rows=4, block_v=512)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        xe.softmax_xent_bwd(meta(8), meta(8, 300), meta(8).long(), meta(8), block_rows=4,
                            block_v=512)
    q = meta(1, 4, 16, 16)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_attention_bwd(q, q, meta(1, 2, 16, 16), meta(1, 2, 16, 16), q, meta(1, 4, 16),
                               block_q=64, block_k=64)


def test_scan_sees_the_campaign_and_search_modules():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("campaign/planner.py", "campaign/scheduler.py", "campaign/runner.py",
                "campaign/transfer.py", "campaign/cli.py", "campaign/__main__.py",
                "core/search/base.py", "core/search/exhaustive.py",
                "core/search/random_search.py", "core/search/coordinate.py",
                "core/search/anneal.py", "core/search/genetic.py", "core/evaluate.py",
                "kernels/fused.py"):
        assert f"src/repro_torch/{mod}" in names


def test_campaign_entry_points_raise_without_a_card(no_card, tmp_path):
    from repro_torch.campaign import cli, planner, runner, scheduler
    from repro_torch.core.database import TuningDatabase
    from repro_torch.core.platform import TORCH_CPU

    manifest = str(tmp_path / "c.json")
    for argv in (["plan", "--reduced", "--out", manifest],
                 ["export", "--db", str(tmp_path / "db.json"), "--out", str(tmp_path / "o")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    jobs = planner.plan_serving_jobs(get_config("qwen2_0_5b").reduced(), 2, 16)
    scheduler.build_manifest(jobs, 40, path=manifest, profile=TORCH_CPU, min_budget=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--manifest", manifest, "--db", str(tmp_path / "db.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_campaign(scheduler.CampaignManifest.load(manifest), TuningDatabase(None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2_0_5b", "--smoke", "--warmup", "--platform", "x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "1", "--bwd-dispatch", "off"])


def test_fused_wrappers_never_fall_back_off_the_cpu():
    from repro_torch.kernels import fused as fu

    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fu.matmul_bias_act(meta(8, 16), meta(16, 32), meta(32), bm=16, bn=64, bk=64, stages=4,
                           splits=1)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fu.rmsnorm_matmul(meta(8, 16), meta(16), meta(16, 32), bm=16, bn=64, bk=64, stages=4,
                          splits=1)


def test_train_launcher_switches_the_backward_plane(capsys):
    train.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "1", "--device", "cpu",
                "--bwd-dispatch", "off"])
    out = capsys.readouterr().out
    assert "phase fwd" in out and "phase bwd" not in out     # reference VJPs dispatch nothing
    train.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "1", "--device", "cpu",
                "--platform", "h100-sxm"])
    out = capsys.readouterr().out
    assert "phase bwd" in out and "|h100-sxm|" in out and "|torch-cpu|" not in out
