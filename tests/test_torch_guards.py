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
jax = pytest.importorskip("jax")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import platform  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
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
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_scan_sees_the_whole_package():
    names = {p.name for p in SOURCES}
    assert {"runtime.py", "matmul.py", "engine.py", "serve.py", "chip_smoke.py"} <= names


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
        mm.matmul(meta(8, 16), meta(16, 32), bm=16, bn=32, bk=16)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        rn.rmsnorm(meta(8, 16), meta(16), block_rows=8)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_attention(meta(1, 4, 16, 16), meta(1, 2, 16, 16), meta(1, 2, 16, 16),
                           block_q=16, block_k=32)


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
