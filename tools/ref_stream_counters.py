"""Counters of the reference streaming engine in ``chip_smoke.py``'s pool run.

``chip_smoke.py`` (phases 6 and 7) drives the PyTorch port's
``EndCloudServingEngine`` on full-width switch-base through an expert-pool
memory shrink and regrow, and holds its counters to the reference
engine's in the same scenario.  The card's machine has no JAX, so this
script reads them off the reference (``src/repro``) on a CPU:

    PYTHONPATH=src python tools/ref_stream_counters.py [--num-layers 4]

It runs the scenario at switch-base's full width (d_model 768, 8 experts of
d_ff 3072, bf16 activations, f32 params) with the int8 streams off and on.
Every request has ``eos_id=-1``, so the counters depend on the schedule and
the shapes, not on the weights or the tokens.  The depth is cut to
``--num-layers`` (default 4: two blocks, so split 1 still leaves a cloud
tier and the codec applies) to keep the run small; at split 1 only block 0
is on the end tier whatever the depth.  The unquantized run must reproduce
the full-depth counters that ``chip_smoke.py`` checks in phase 6
(``POOL_COUNTERS`` below, read at full depth); the script fails if it does
not, which is its check that the cut depth leaves the counters alone.
Prints one JSON object per run.
"""

from __future__ import annotations

import argparse
import json

import jax
import numpy as np

from repro.configs import get_config
from repro.core.expertpool import expert_slab_bytes
from repro.core.hardware import PROFILES, DeviceProfile, DeviceState
from repro.models.model import build_model
from repro.serving.common import Request
from repro.serving.stream import EndCloudServingEngine

# phase 6's counters at full depth (chip_smoke.py's POOL_COUNTERS)
POOL_COUNTERS = {"n_expert_evictions": 2, "n_expert_prefetches": 2,
                 "expert_bytes_down": 37748736, "n_stage_steps": 140,
                 "n_prefill_chunks": 74, "bytes_up": 1986816}
QUANT = dict(quantize_kv=True, quantize_experts=True, quantize_boundary=True)


def requests(vocab, n, seed, new, hi=200, base=0):
    """``chip_smoke.stream_requests``: the length drawn before each prompt."""
    rng = np.random.default_rng(seed)
    return [Request(base + i, rng.integers(0, vocab, size=int(rng.integers(16, hi)))
                    .astype(np.int32), max_new_tokens=new) for i in range(n)]


def pool_run(model, params, **flags) -> dict:
    cfg = model.cfg
    jet = PROFILES["jetson-orin"]
    slab = expert_slab_bytes(cfg)  # the f32 slab: phase 6's memory, in both runs
    end = DeviceProfile("jetson-orin-slabs", peak_gflops=jet.peak_gflops,
                        mem_gb=2 * 1 * 3 * slab / 1e9, mem_bw_gbs=jet.mem_bw_gbs,
                        net_gbps=jet.net_gbps)
    eng = EndCloudServingEngine(
        model, params, end_profile=end, cloud_profile=PROFILES["a100"],
        compression_rank=384, max_batch=8, n_groups=2, page_size=16, prefill_chunk=32,
        max_len=256, force_split=1, timing="modeled", **flags)
    reqs = requests(cfg.vocab_size, 8, 0, 32)
    for r in reqs:
        eng.submit(r)
    tick = 0
    while eng.busy() or tick < 12:
        if tick == 6:
            eng.update_device_state(DeviceState(mem_free=0.5))
        if tick == 12:
            eng.update_device_state(DeviceState(mem_free=1.0))
            more = requests(cfg.vocab_size, 8, 1, 32, base=100)
            for r in more:
                eng.submit(r)
            reqs += more
        eng.step()
        tick += 1
    m = eng.metrics()
    assert all(r.done and len(r.generated) == 32 for r in reqs)
    return {
        "flags": sorted(flags), "ticks": tick, "split": eng.split,
        "compressed": bool(eng.tiers.compress), "replan_events": len(eng.replan_events),
        "n_expert_evictions": eng.n_expert_evictions,
        "n_expert_prefetches": eng.n_expert_prefetches,
        "expert_bytes_down": eng.expert_bytes_down, "n_stage_steps": eng.n_stage_steps,
        "n_prefill_chunks": eng.n_prefill_chunks, "bytes_up": eng.link.bytes_up,
        **{k: m[k] for k in ("kv_capacity_ratio", "kv_page_bytes", "kv_page_bytes_dense",
                             "expert_slab_bytes", "expert_slab_bytes_dense",
                             "expert_capacity_ratio", "expert_slab_capacity",
                             "expert_hit_rate")},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-layers", type=int, default=4)
    args = ap.parse_args()
    cfg = get_config("switch-base").replace(num_layers=args.num_layers)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    plain = pool_run(model, params)
    print(json.dumps(plain), flush=True)
    got = {k: plain[k] for k in POOL_COUNTERS}
    if got != POOL_COUNTERS or plain["replan_events"]:
        raise SystemExit(f"depth {args.num_layers}: counters {got} differ from the "
                         f"full-depth {POOL_COUNTERS}")
    print(json.dumps(pool_run(model, params, **QUANT)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
