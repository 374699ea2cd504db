"""The step-1 training gate of ``chip_smoke.py`` on the CPU.

``gate_step1`` holds the trainer's kernel path against the plain path:
the loss with each path on its own, and layer by layer, the plain path fed
the kernel path's layer outputs and their cotangents (``LayerTap``), every
gradient leaf, every layer's input cotangent and every layer's output less
its input. On the CPU the
kernel path runs each kernel's plain version and the scan's gradient
through the dispatched ``ssm_scan_bwd`` tunable, so the two paths agree
and the gate must pass, for reduced Jamba without experts and for reduced
Mixtral on replayed routes. A wrong scan must fail it: ``d_dt`` or
``d_A`` 5% off inside ``ssm_scan_bwd`` (the gate names the step-size
leaves, or ``A_log``), ``d_xc`` doubled (the cotangent a Mamba layer hands
down; ``d_xc`` 5% off moves that cotangent by less than TOL_GRAD, since
the skip term and ``x_proj`` carry the rest of xc's gradient), or the
forward's ``y`` half again too large: the backward recomputes from the
inputs, so it shows in the layer's output and in ``out_proj``'s gradient
(``y`` 5% off moves them by 2.2e-2 and 2.6e-2 here, under TOL_GRAD).

Reduced xLSTM in bf16 (alternating mLSTM and sLSTM, no FFN: each layer's
contribution is its mixer's output, and each mLSTM recurrence is pinned
inside its layer) passes on equal paths, with every cotangent at a pinned
recurrence's output equal. Every ``matmul`` launch of the kernel path is
also held against the plain version on its own operands (``DispatchTap``),
so a kernel that is wrong fails the gate twice, at the launch and in the
layers, when its forward launches or its backward ones (those with a
transposed operand) return 5% too much; an fp32 launch 0.1% off (the mLSTM's ``out_proj``, above
TOL_F32_GEMM but far under TOL_GRAD) fails it at the launch.
"""
import dataclasses
import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core

import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.annotate import get_tunable  # noqa: E402
from repro_torch.core.runtime import ensure_registered  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels.matmul import layout  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=32)
DATA = DataConfig(seed=0, batch_size=2, seq_len=24)


@pytest.fixture()
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gate(smoke, arch: str, **over):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    trainer = Trainer(cfg, RUN, DATA, adamw.AdamWConfig(warmup_steps=1, total_steps=1),
                      TrainerConfig(total_steps=1), runtime=repro_torch.runtime(),
                      device="cpu")
    aux = smoke.gate_step1(trainer, cfg, RUN, DATA, arch,
                           replay_routes=cfg.num_experts > 0)
    return aux, list(smoke.GATE_FAILURES)


def test_gate_passes_equal_paths(smoke):
    _, failures = _gate(smoke, "jamba_1_5_large", num_experts=0, experts_per_token=0)
    assert failures == []


def test_gate_passes_moe_on_replayed_routes(smoke):
    aux, failures = _gate(smoke, "mixtral_8x7b")
    assert failures == []
    assert aux is not None and torch.isfinite(torch.tensor(aux)) and aux > 0


@pytest.mark.parametrize("site, arg, scale, names, count", [
    ("ssm_scan_bwd", 1, 1.05, ("mixer/dt_proj", "mixer/dt_bias"), None),
    ("ssm_scan_bwd", 4, 1.05, ("mixer/A_log",), None),
    ("ssm_scan_bwd", 0, 2.0, (), "cotangents handed down"),
    ("ssm_scan", 0, 1.5, (), "layer outputs less their inputs"),
], ids=["d_dt", "d_A", "d_xc", "y"])
def test_gate_fails_a_wrong_scan(smoke, monkeypatch, site, arg, scale, names, count):
    ensure_registered()
    t = get_tunable(site)
    fn = t.fn

    def wrong(*args, **kw):
        out = list(fn(*args, **kw))
        out[arg] = out[arg] * scale
        return tuple(out)

    monkeypatch.setattr(t, "fn", wrong)
    _, failures = _gate(smoke, "jamba_1_5_large", num_experts=0, experts_per_token=0)
    assert len(failures) == 1
    assert all(n in failures[0] for n in names), failures[0]
    if count is not None:
        n = int(re.search(rf"; (\d+) {count}", failures[0]).group(1))
        assert n > 0, failures[0]


XLSTM = dict(dtype="bfloat16")


def test_xlstm_gate_passes_equal_paths(smoke):
    _, failures = _gate(smoke, "xlstm_1_3b", **XLSTM)
    assert failures == []


@pytest.mark.parametrize("when, dtype, scale, layers", [
    ("forward", torch.bfloat16, 1.05, True),
    ("backward", torch.bfloat16, 1.05, True),
    ("forward", torch.float32, 1.001, False),
], ids=["bf16-fwd", "bf16-bwd", "f32-fwd"])
def test_xlstm_gate_fails_a_wrong_matmul(smoke, monkeypatch, when, dtype, scale, layers):
    ensure_registered()
    t = get_tunable("matmul")
    fn = t.fn

    def wrong(x, w, **kw):
        out = fn(x, w, **kw)
        bwd = layout(x)[0] or layout(w)[0]
        hit = x.dtype == dtype and bwd == (when == "backward")
        return out * scale if hit else out

    monkeypatch.setattr(t, "fn", wrong)
    _, failures = _gate(smoke, "xlstm_1_3b", **XLSTM)
    launch = [f for f in failures if "matmul launches differ" in f]
    assert len(launch) == 1, failures
    assert ("bf16" if dtype == torch.bfloat16 else "f32") in launch[0]
    assert (len(failures) == 2) == layers, failures
