"""The serving gates of ``chip_smoke.py``'s xLSTM phase on the CPU.

A prefill and a decode step of reduced xLSTM-1.3B in bf16 run on the
kernel path (kernel mode; on the CPU each kernel's plain version) with
every ``matmul`` launch held against the plain version on its own operands
(``DispatchTap``) and each layer recorded (``PrefillTap``), then on the
plain path pinned to the kernel path's layer outputs; ``_gate_serving``
holds each layer's contribution (the mixer's output: the xLSTM has no FFN)
and each state leaf at TOL_GRAD and the head at TOL_LOGITS. On equal
paths the gate passes. A ``matmul`` kernel whose bf16 launches return 5%
too much fails it twice, at the launches and in the layers; one whose fp32
launches (the mLSTM's ``out_proj``) return 0.1% too much, above
TOL_F32_GEMM and far under TOL_GRAD, fails it at the launches.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.annotate import get_tunable  # noqa: E402
from repro_torch.core.runtime import ensure_registered, runtime  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(get_config("xlstm_1_3b").reduced(), dtype="bfloat16")
RUN = RunConfig(mlstm_chunk=8)
L, CACHE = 21, 32


@pytest.fixture()
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gates(smoke):
    """Gate a prefill of L tokens and the decode step after it; returns
    GATE_FAILURES."""
    params = lm.init_params(CFG, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, CFG.vocab_size, (1, L)))
    kern = lambda: runtime(mode="kernel", name="kernel")
    plain = lambda: runtime(mode="reference", name="plain")
    with torch.inference_mode():
        pre = lambda: lm.prefill(params, {"tokens": toks}, CFG, RUN, cache_len=CACHE)
        with kern(), smoke.PrefillTap(states=True) as rec, smoke.DispatchTap() as held:
            lk, cache = pre()
        with plain(), smoke.PrefillTap(pin=rec, states=True) as pin:
            lq, _ = pre()
        smoke._gate_serving("xlstm", "prefill", CFG.num_layers, rec, pin, held, (lk, lq))
        pool = lm.insert_cache(lm.init_cache(CFG, 1, CACHE, "cpu"), cache, 0)
        before = smoke._clone_tree(pool)
        nxt, at = lk.argmax(-1, keepdim=True), torch.tensor([L])
        dec = lambda caches: lm.decode_step(params, nxt, caches, at, CFG, RUN)[0]
        with kern(), smoke.PrefillTap(mode="decode", states=True) as rec, \
                smoke.DispatchTap() as held:
            lk = dec(pool)
        with plain(), smoke.PrefillTap(pin=rec, mode="decode", states=True) as pin:
            lq = dec(before)
        smoke._gate_serving("xlstm", "decode", CFG.num_layers, rec, pin, held, (lk, lq))
    return list(smoke.GATE_FAILURES)


def test_serving_gate_passes_equal_paths(smoke):
    assert _gates(smoke) == []


@pytest.mark.parametrize("dtype, scale, layers", [
    (torch.bfloat16, 1.05, True), (torch.float32, 1.001, False)], ids=["bf16", "f32"])
def test_serving_gate_fails_a_wrong_matmul(smoke, monkeypatch, dtype, scale, layers):
    ensure_registered()
    t = get_tunable("matmul")
    fn = t.fn

    def wrong(x, w, **kw):
        out = fn(x, w, **kw)
        return out * scale if x.dtype == dtype else out

    monkeypatch.setattr(t, "fn", wrong)
    failures = _gates(smoke)
    launch = [f for f in failures if "matmul launches differ" in f]
    assert len(launch) == 2, failures                 # the prefill's and the decode step's
    assert (len(failures) == 4) == layers, failures
