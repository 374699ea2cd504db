"""Host cost of the dispatch path on the serving engine's decode step, one
tree at a time, so two commits can be compared on one card.

Serves chip_smoke.py's serve-phase mix on full-width qwen2_0_5b (random
weights from ``--seed``, 8 slots, ``max_seq=2048``, 16 requests of 16-1500
tokens, 32 new each) and reads the engine's decode-step times; then times
one dispatch of the decode q projection's matmul bucket ([8,896]@[896,896],
bf16) over 2,000 calls. The variants run in turns within the process:
``default`` (the tree's default runtime), ``tuned`` (a database holding the
heuristic config of every key the serving planner names, so each planned
dispatch is an exact hit and each fused site with a record is opted in:
``fusion_wins`` checks the record's config against its space at every such
call) and, where the tree's runtime has a guard, ``guard-off``. The tuned
variant also counts the space checks a serve makes and times one
``space.is_valid`` of the fused unembed's record over 20,000 calls. Each
process appends one JSON line a variant to ``--out``; ``--summarize``
prints the medians and spread by tree and variant over every process.

Run from the root of a checkout on a machine with a card; for another
tree, put its ``src`` first on ``PYTHONPATH`` (its kernel sources must be
the same, so both trees share the built libraries):

    PYTHONPATH=src python3 scripts/decode_ab.py --label change --out ab.jsonl
    PYTHONPATH=parent/src python3 scripts/decode_ab.py --label parent --out ab.jsonl
    python3 scripts/decode_ab.py --summarize ab.jsonl
"""
from __future__ import annotations

import argparse
import inspect
import json
import time

import numpy as np

LENGTHS = (16, 1500, 23, 700, 40, 1300, 64, 1024, 100, 900, 130, 512, 200, 400, 256, 300)


def tuned_db(cfg):
    """An in-memory database: each key the serving planner names, at its
    tunable's heuristic config (keys whose heuristic cannot be read from
    the shapes alone are left out)."""
    import torch

    from repro_torch.campaign import planner
    from repro_torch.core.annotate import get_tunable
    from repro_torch.core.database import Record, TuningDatabase
    from repro_torch.core.platform import detect_platform

    plat = detect_platform("cuda").name
    db = TuningDatabase(None)
    for j in planner.plan_serving_jobs(cfg, max_batch=8, max_seq=2048, max_tokens=65536):
        metas = [torch.empty(s, dtype=getattr(torch, d), device="meta")
                 for s, d in zip(j.arg_shapes, j.arg_dtypes)]
        try:
            config = get_tunable(j.kernel).default_config(*metas)
        except Exception:
            continue
        db.put(Record(key=j.db_key(plat), config=config, objective=1.0, evaluator="heuristic",
                      evaluations=0, timestamp=0.0), save=False)
    return db


def measure(label: str, turns: int, seed: int, out: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.annotate import get_tunable
    from repro_torch.core.runtime import dispatch, runtime
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    if not torch.cuda.is_available():
        raise SystemExit("decode_ab.py measures on a card: no CUDA device")
    cfg = get_config("qwen2_0_5b")
    params = lm.init_params(cfg, seed=seed, device="cuda")
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    run = RunConfig()
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in LENGTHS]
    db = tuned_db(cfg)
    variants = {"default": {}, "tuned": {"db": db}}
    if "guard" in inspect.signature(runtime).parameters:
        variants["guard-off"] = {"guard": False}
    rts = {v: runtime(name=f"ab-{v}", **kw) for v, kw in variants.items()}
    # the fused sites' space (matmul's, shared by both fused tunables): its
    # checks counted over the tuned serves
    space = get_tunable("rmsnorm_matmul").space
    unembed = next(r.config for r in db.records() if r.key.startswith("rmsnorm_matmul|"))
    checks = {"n": 0}
    real_is_valid = space.is_valid

    def counted(config):
        checks["n"] += 1
        return real_is_valid(config)
    d = cfg.d_model
    qx = torch.randn((8, d), device="cuda").to(torch.bfloat16)
    qw = torch.randn((d, d), device="cuda").to(torch.bfloat16)
    steps = {v: [] for v in variants}
    calls = {v: [] for v in variants}
    valid_us, serve_checks = [], []
    for turn in range(turns + 1):          # turn 0 warms every bucket up
        for v, rt in rts.items():
            eng = ServingEngine(cfg, run, params, ecfg, runtime=rt)
            for i, p in enumerate(prompts):
                eng.submit(Request(prompt=p, max_new_tokens=32,
                                   temperature=0.0 if i % 2 == 0 else 0.8,
                                   seed=seed + i, arrival_time=float(2 * i)))
            if v == "tuned":
                checks["n"] = 0
                space.is_valid = counted
            try:
                eng.serve()
            finally:
                space.__dict__.pop("is_valid", None)
            if v == "tuned" and turn:
                serve_checks.append(checks["n"] / max(len(eng.timings["decode_s"]), 1))
                space.is_valid(unembed)
                t0 = time.perf_counter()
                for _ in range(20000):
                    space.is_valid(unembed)
                valid_us.append((time.perf_counter() - t0) * 1e6 / 20000)
            with rt:
                dispatch("matmul", qx, qw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    dispatch("matmul", qx, qw)
                torch.cuda.synchronize()
                us = (time.perf_counter() - t0) * 1e6 / 2000
            if turn:
                steps[v] += [1e3 * t for t in eng.timings["decode_s"]]
                calls[v].append(us)
    with open(out, "a") as f:
        for v in variants:
            row = {"label": label, "variant": v, "decode_ms": steps[v], "dispatch_us": calls[v]}
            if v == "tuned":
                row.update(is_valid_us=valid_us, checks_per_decode_step=serve_checks,
                           records=len(db))
            f.write(json.dumps(row) + "\n")
            print(f"{label} {v}: decode step median {np.median(steps[v]):.3f} ms of "
                  f"{len(steps[v])}; one dispatch {np.median(calls[v]):.3f} us "
                  f"(turns {', '.join(f'{u:.3f}' for u in calls[v])})", flush=True)
        print(f"{label} tuned: {len(db)} records; space checks a decode step (prefills "
              f"included) {', '.join(f'{c:.2f}' for c in serve_checks)}; one is_valid of the "
              f"unembed's record {', '.join(f'{u:.3f}' for u in valid_us)} us", flush=True)


def summarize(path: str) -> None:
    rows = [json.loads(line) for line in open(path)]
    groups = {}
    for r in rows:
        g = groups.setdefault((r["label"], r["variant"]),
                              {"proc": [], "steps": [], "us": [], "valid": [], "checks": []})
        g["proc"].append(float(np.median(r["decode_ms"])))
        g["steps"] += r["decode_ms"]
        g["us"] += r["dispatch_us"]
        g["valid"] += r.get("is_valid_us", [])
        g["checks"] += r.get("checks_per_decode_step", [])
    for (label, v), g in sorted(groups.items()):
        s = np.asarray(g["steps"])
        print(f"{label:>8} {v:<9}: decode step median {np.median(s):.3f} ms "
              f"(p10 {np.percentile(s, 10):.3f}, p90 {np.percentile(s, 90):.3f}, "
              f"n={s.size}); process medians "
              f"{', '.join(f'{m:.3f}' for m in g['proc'])} ms; one dispatch median "
              f"{np.median(g['us']):.3f} us (min {min(g['us']):.3f}, max {max(g['us']):.3f}, "
              f"n={len(g['us'])})"
              + (f"; is_valid {np.median(g['valid']):.3f} us (n={len(g['valid'])}), "
                 f"{np.median(g['checks']):.2f} space checks a decode step" if g["valid"] else ""))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/decode_ab.jsonl")
    ap.add_argument("--summarize", default=None, metavar="JSONL")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize)
    else:
        measure(args.label, args.turns, args.seed, args.out)


if __name__ == "__main__":
    main()
