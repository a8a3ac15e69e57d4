#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. The card's name and power limit, torch / CUDA / Triton versions, and the
   build of the CUDA kernels (one ``nvcc`` per source, all at once).
2. Each hand-written kernel against its plain PyTorch version on the card,
   at the serving path's shapes, in bf16, with the tolerance stated beside
   it: the kernel's time (L2 flushed before every launch), the plain
   version's, the least time the card could take for the same work
   (``bound_ms``), and one PyTorch library call of the same function where
   one exists (``library_ms``, a yardstick the port never calls).
3. Full-width switch-base (12 layers, d_model 768, 8 experts) with random
   weights from a seeded generator, serving 8 requests (prompts of 16-200
   tokens, 32 new tokens each) through ``ServingEngine`` on the card.  The
   kernels' launch counters are zeroed just before and read just after;
   every kernel must have launched, every request must finish and the KV
   page pool must be empty again.  Step times, tokens/s and peak memory.
4. The first prefill chunk and one decode step of a short prompt on the card
   against the same model on the CPU (plain versions, same bf16 weights).

The last lines are the kernels' JSON record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.  A ``torch.profiler``
table of one decode step goes to ``chiprun_out/decode_profile.txt`` and the
compiler's register / spill report to ``chiprun_out/nvcc_build.log``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (dense rates below too)
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of a callable over ``iters`` launches, each after an
    L2 flush (the serving step reaches every layer's weights and pages cold:
    the weights alone are 660 MB against a 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, rtol: float, atol: float) -> float:
    """Elementwise ``|out - ref| <= atol + rtol * |ref|``; returns max |out - ref|."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * ref.abs()).all())
    log(f"  {name}: max_abs_err={err:.3e} rtol={rtol:.3e} atol={atol:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"beyond rtol={rtol} atol={atol} (max |diff| {err})")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_attention_inputs(torch, C: int, seed: int):
    """B=8 slots, 12 kv heads of 64, 16-token pages, a 16-page ring (256
    tokens); ragged lengths, a 1-token slot and one slot past a ring wrap."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, hd, ps, pps = 8, 12, 64, 16, 16
    lengths = torch.tensor([0, 15, 16, 47, 100, 199, 231, 300], dtype=torch.int32)
    P = B * pps
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed)).view(B, pps)
    table = torch.full((B, pps), P, dtype=torch.int32)
    for b in range(B):
        mapped = min(pps, int(lengths[b]) // ps + 1)
        table[b, :mapped] = perm[b, :mapped].int()
    q_pos = lengths[:, None] - (C - 1) + torch.arange(C, dtype=torch.int32)[None, :]
    q_pos = q_pos.clamp_min(0).int()
    dev = dict(device="cuda")
    q = torch.randn(B, C, H, hd, generator=g, **dev).bfloat16()
    pool_k = torch.randn(P + 1, ps, H, hd, generator=g, **dev).bfloat16()
    pool_v = torch.randn(P + 1, ps, H, hd, generator=g, **dev).bfloat16()
    return q, pool_k, pool_v, table.cuda(), q_pos.cuda(), lengths.cuda()


def run_paged_attention(torch, timer):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
    from repro_torch.models.kvcache import paged_gather, ring_key_positions

    rec = {}
    for C in (1, 32):
        args = paged_attention_inputs(torch, C, seed=C)
        q, pool_k, pool_v, table, q_pos, lengths = args
        out = paged_attention(*args)
        ref = paged_attention_plain(*args)
        # Both sides accumulate in f32 and round once to bf16, in another
        # order: one to two bf16 ulps of each element (rtol 2^-7), and four
        # ulps at the median |output| (atol) for elements near zero.
        atol = 2 ** -6 * ref.float().abs().median().item()
        err = check_close(f"paged_attention C={C}", out, ref, rtol=2 ** -7, atol=atol)

        B, _, H, hd = q.shape
        ps, pps = pool_k.shape[1], table.shape[1]
        W = ps * pps
        kp = ring_key_positions(lengths, W)  # [B, W]
        vis = (kp[:, None, :] <= q_pos[:, :, None].long()) & (kp[:, None, :] >= 0)
        live = vis.view(B, C, pps, ps).any(dim=(1, 3)) & (table != pool_k.shape[0] - 1)
        page_bytes = 2 * ps * H * hd * 2  # K and V of one page, bf16
        nbytes = (2 * q.numel() * 2 + int(live.sum()) * page_bytes
                  + (table.numel() + q_pos.numel() + lengths.numel()) * 4)
        flops = 4 * hd * H * int(vis.sum())
        b_ms, b_by = bound(nbytes, flops, "bf16")

        # yardstick: SDPA over the pre-gathered dense ring with a boolean mask
        kd = paged_gather(pool_k, table).transpose(1, 2)  # [B, H, W, hd]
        vd = paged_gather(pool_v, table).transpose(1, 2)
        qd = q.transpose(1, 2)
        mask = vis[:, None]  # [B, 1, C, W]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
        ms = timer(lambda: paged_attention(*args))
        plain_ms = timer(lambda: paged_attention_plain(*args), iters=5)
        log(f"  paged_attention C={C}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) library_ms(sdpa)={lib_ms:.4f} "
            f"live_pages={int(live.sum())}")
        rec[C] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms)
    return rec[1]


def run_group_gate(torch, timer):
    from repro_torch.configs import get_config
    from repro_torch.core.gating import init_group_gate
    from repro_torch.kernels.group_gate import group_gate, group_gate_plain

    cfg = get_config("switch-base")
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = init_group_gate(gen, cfg.d_model, cfg.moe)
    # a nonzero bias makes the bias path count
    p["b_local"].normal_(generator=gen)
    p["b_global"].normal_(generator=gen)
    E, K, d = cfg.moe.num_experts, cfg.moe.num_groups, cfg.d_model
    rec = {}
    for T in (8, 256):
        x = torch.randn(T, d, generator=gen, device="cuda").bfloat16()
        for mask in (None, torch.tensor([1, 0, 0, 0, 1, 1, 0, 1], dtype=torch.bool, device="cuda")):
            args = (x, p["w_local"], p["b_local"], p["w_global"], p["b_global"], mask)
            probs, pg = group_gate(*args)
            rprobs, rpg = group_gate_plain(*args)
            # f32 throughout; the logits (|l| ~ 15) are summed in another order
            tag = f"T={T} mask={'yes' if mask is not None else 'no'}"
            err = max(check_close(f"group_gate probs {tag}", probs, rprobs, rtol=0, atol=1e-4),
                      check_close(f"group_gate p_group {tag}", pg, rpg, rtol=0, atol=1e-4))
            if mask is None:
                nbytes = T * d * 2 + d * (E + K) * 4 + (E + K) * 4 + T * (E + K) * 4
                b_ms, b_by = bound(nbytes, 2 * T * d * (E + K), "f32")
                ms = timer(lambda: group_gate(*args))
                plain_ms = timer(lambda: group_gate_plain(*args))
                log(f"  group_gate T={T}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={b_ms:.6f} ({b_by}) library_ms=null")
                rec[T] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None)
            else:
                rec[T]["max_abs_err"] = max(rec[T]["max_abs_err"], err)
    return rec[8]


def run_expert_mlp(torch, timer):
    from repro_torch.configs import get_config
    from repro_torch.core.moe import init_moe
    from repro_torch.kernels.expert_mlp import grouped_mlp, grouped_mlp_plain

    cfg = get_config("switch-base")
    gen = torch.Generator(device="cuda").manual_seed(2)
    p = init_moe(gen, cfg)  # the model's own shapes and init scales
    wi, wo = p["wi"].bfloat16(), p["wo"].bfloat16()
    E, d, f = wi.shape
    rec = {}
    cases = [
        ("decode n=8", [3, 0, 2, 0, 1, 1, 0, 1], "gelu", None),
        ("prefill n=32", [12, 0, 9, 3, 0, 5, 1, 2], "gelu", None),
        ("gated silu n=8", [0, 2, 2, 0, 0, 3, 1, 0], "silu",
         (torch.randn(E, d, f, generator=gen, device="cuda") / E ** 0.5).bfloat16()),
    ]
    for name, sizes, act, wg in cases:
        n = sum(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        xs = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        args = (xs, gs, wi, wg, wo, act)
        y = grouped_mlp(*args)
        ref = grouped_mlp_plain(*args)
        # the kernel keeps the hidden activation in f32 where the plain
        # version (as ragged_dot) rounds it to bf16: a few bf16 ulps of |y|
        tol = 2e-2 * ref.float().abs().max().item()
        err = check_close(f"expert_mlp {name}", y, ref, rtol=0, atol=tol)
        if name.startswith("gated"):
            continue
        routed = sum(1 for s in sizes if s)
        nbytes = 2 * n * d * 2 + routed * 2 * d * f * 2 + E * 4
        b_ms, b_by = bound(nbytes, 2 * 2 * n * d * f, "bf16")
        ms = timer(lambda: grouped_mlp(*args))
        plain_ms = timer(lambda: grouped_mlp_plain(*args))
        log(f"  expert_mlp {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) library_ms=null routed_experts={routed}")
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    return rec["decode n=8"]


# ---------------------------------------------------------------------------
# Phase 3-4: serve full-width switch-base, and hold it against the CPU
# ---------------------------------------------------------------------------


def serve(torch, counters):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, leaves
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("switch-base")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, params, max_batch=8, max_len=256, page_size=16,
                        prefill_chunk=32)
    del params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(eng.params))
    log(f"switch-base: {n_params / 1e6:.1f} M params, built in "
        f"{time.perf_counter() - t0:.2f} s; {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts in {cfg.moe.num_groups} groups")

    rng = np.random.default_rng(0)
    prompt_lens = [16, 40, 77, 100, 128, 150, 181, 200]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=32) for i, n in enumerate(prompt_lens)]

    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    for r in reqs:
        eng.submit(r)
    step_s = []
    t_run = time.perf_counter()
    while eng.busy():
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    run_s = time.perf_counter() - t_run
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    log(f"serving launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was never launched on the serving path")
    bad = [r.request_id for r in reqs if not r.done or len(r.generated) != 32]
    if bad:
        raise AssertionError(f"requests {bad} did not finish with 32 tokens")
    if eng.pool.pages_in_use != 0:
        raise AssertionError(f"{eng.pool.pages_in_use} KV pages still mapped after the run")
    n_tok = sum(len(r.generated) for r in reqs)
    decode_steps = sorted(step_s[1:])
    log(f"first step (8 chunked prefills + 1 decode): {step_s[0] * 1e3:.3f} ms")
    log(f"decode step: median {decode_steps[len(decode_steps) // 2] * 1e3:.3f} ms, "
        f"min {decode_steps[0] * 1e3:.3f} ms, max {decode_steps[-1] * 1e3:.3f} ms "
        f"over {len(decode_steps)} steps (host clock, synchronized)")
    log(f"tokens/s: {n_tok / run_s:.1f} ({n_tok} tokens in {run_s:.3f} s, 8 requests)")
    log(f"peak device memory: {peak / 2**20:.1f} MiB")

    # per-step launches and the prefill-chunk time, on a fresh slot
    for c in counters:
        c.launches = 0
    eng.pool.reserve(0, 2)
    eng.pool.map_range(0, 0, 32)
    table = eng.pool.device_rows([0], device="cuda")
    chunk = torch.randint(0, cfg.vocab_size, (1, 32), device="cuda", dtype=torch.int32)
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    n_valid = torch.full((1,), 32, dtype=torch.int32, device="cuda")

    def prefill():
        return model.prefill_chunk_step(eng.params, chunk, eng.pages, table, start,
                                        n_valid, page_size=16)

    prefill()
    per_chunk = {c.__name__: c.launches for c in counters}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        prefill()
    ev[1].record()
    torch.cuda.synchronize()
    log(f"prefill chunk (C=32, B=1): {ev[0].elapsed_time(ev[1]) / 10:.3f} ms (device events); "
        f"launches per chunk {per_chunk}")
    eng.pool.free(0)

    # decode-step launches, and a profile of one decode step
    for c in counters:
        c.launches = 0
    eng.submit(Request(99, np.arange(20, dtype=np.int32), max_new_tokens=4))
    eng.step()  # admission + decode
    for c in counters:
        c.launches = 0
    eng.step()
    log(f"launches per decode step: {({c.__name__: c.launches for c in counters})}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    table_txt = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (OUT_DIR / "decode_profile.txt").write_text(table_txt)
    log("decode profile (1 step) written to chiprun_out/decode_profile.txt")
    eng.run()
    return launches, eng


def reference_check(torch, eng):
    """Prefill chunk + one decode step of a 16-token prompt, on the card
    (kernels) and on the CPU (plain versions), same bf16 weights."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import Model, to_device

    cfg = eng.model.cfg
    prompt = torch.arange(100, 116, dtype=torch.int32)
    chunk = torch.zeros(1, 32, dtype=torch.int32)
    chunk[0, :16] = prompt
    out = {}
    for dev, params in (("cuda", eng.params), ("cpu", to_device(eng.params, "cpu"))):
        model = Model(cfg, device=dev)
        pool = kvcache.PagePool(4, 16, 4, n_slots=1)
        pool.reserve(0, 4)
        pool.map_range(0, 0, 17)
        pages = kvcache.init_paged_blocks(cfg, cfg.block_repeat, 4, 16, cfg.torch_dtype, dev)
        table = pool.device_rows([0], device=dev)
        ints = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        lg1, pages = model.prefill_chunk_step(params, chunk.to(dev), pages, table,
                                              ints([0]), ints([16]), page_size=16)
        tok = lg1.argmax(-1).int()[:, None]
        lg2, _ = model.decode_step_paged(params, tok, pages, table, ints([16]), page_size=16)
        V = cfg.vocab_size  # the padded tail is -1e30 on both sides
        out[dev] = (lg1[:, :V].float().cpu(), lg2[:, :V].float().cpu(), tok.cpu())
    for i, name in enumerate(("prefill-chunk logits", "decode logits")):
        g, c = out["cuda"][i], out["cpu"][i]
        rel = ((g - c).abs().max() / c.abs().max()).item()
        cos = torch.nn.functional.cosine_similarity(g, c, dim=-1).min().item()
        same = bool((g.argmax(-1) == c.argmax(-1)).all())
        log(f"  {name}: card vs CPU max|diff|/max|cpu|={rel:.3e} cos={cos:.6f} "
            f"argmax equal={same} finite={bool(torch.isfinite(g).all())}")
        # bf16 activations through 12 layers, summed in other orders
        if not (torch.isfinite(g).all() and rel <= 0.1 and cos >= 0.99):
            raise AssertionError(f"{name}: the card disagrees with the CPU reference")
    if not torch.equal(out["cuda"][2], out["cpu"][2]):
        log("  note: first generated token differs between card and CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.expert_mlp import grouped_mlp
    from repro_torch.kernels.group_gate import group_gate
    from repro_torch.kernels.paged_attention import paged_attention

    smi = nvidia_smi()
    import triton

    log(f"card: {smi}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} triton {triton.__version__} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = build.build()
    log(f"kernel build (nvcc, {len(build.SOURCES)} sources in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc_build.log").write_text("".join(
        f"== {name}\n{path.with_suffix('.log').read_text()}"
        for name, path in libs.items()
    ))

    timer = Timer(torch)
    log("kernels against their plain versions (bf16, card):")
    t0 = time.perf_counter()
    recs = {
        "paged_attention": run_paged_attention(torch, timer),
        "group_gate": run_group_gate(torch, timer),
        "expert_mlp": run_expert_mlp(torch, timer),
    }
    log(f"kernel checks took {time.perf_counter() - t0:.2f} s")

    counters = [paged_attention, group_gate, grouped_mlp]
    launches, eng = serve(torch, counters)
    log("end-to-end against the CPU reference:")
    reference_check(torch, eng)

    meta = {
        "paged_attention": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:196", "paged_attention"),
        "group_gate": ("triton", "src/repro_torch/kernels/group_gate/ops.py",
                       "src/repro/kernels/group_gate/kernel.py:85", "group_gate"),
        "expert_mlp": ("cuda", "src/repro_torch/csrc/expert_mlp.cu",
                       "src/repro/kernels/expert_mlp/kernel.py:108", "grouped_mlp"),
    }
    kernels = []
    for name, (route, source, replaces, counter) in meta.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[counter], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
