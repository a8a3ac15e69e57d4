"""Time every hand-written kernel of the port on the card, per call, on and
off the device, for any tree's ``src``.

At the shapes ``chip_smoke.py`` checks them at (its case lists, so that the
two stay in step), it reads for each wrapper:

- ``device_us``: the device time of every kernel one call launches, mean
  over 20 calls with the L2 flushed before each (``torch.profiler``, through
  ``chip_smoke.Timer.device_us``);
- ``host_us``, ``host_p10_us``: the host time of one call, median and 10th
  percentile over 300 calls, each started on an idle stream (the launch is
  asynchronous, so this is the Python, the checks, the allocations and the
  launch API; the percentile is the less disturbed by other work on a
  shared host);
- ``max_abs_err`` against the plain version and ``equal_bits`` over three
  more launches;

and the device time of the yardsticks beside them: SDPA (paged attention:
on the pre-gathered dense ring; flash attention: ``is_causal``),
``torch.matmul`` (the codec) and PyTorch's own products for the expert FFN
(``chip_smoke.ffn_yardsticks``).  The kernels, in order: the codec's
encode and decode at 4, 32 and 1024 rows (``--mma-sync`` also builds and
times ``tools/codec_mma_sync.cu``, the ``mma.sync`` form the ``wgmma``
kernel was chosen over); flash attention on the pipeline's [4, 256, 12,
64]; the group gate at 4, 8, 256 and 1024 rows of switch-base's width (and
at 8 rows with a partial mask) and at 8 and 1024 rows of llama4-scout's
(``--gate-generic`` reads each case again with the kernel's generic form
forced, against the exact form the launch plan picks);
one int8 KV layer write of the streaming engine (a decode group and a
prefill chunk, ``kvcache``'s writers, with the device kernels a call
launches); paged attention over dense and int8
pools at ``PA_CASES`` and at the streaming engine's 16-page group; the
expert FFN at ``FFN_CASES`` and ``WIDE_FFN_CASES``, the resident FFN at
``RESIDENT_CASES`` (f32 store) and ``RESIDENT_QUANT_CASES`` (int8 store);
the row quantizer and dequantizer on a raw boundary's rows (no path
quantizes KV rows with them any more: the KV pools' layer write does); the
codec roundtrip's contract form at 1000 rows and the MoE dispatch codec's
form at 4, 8, 32 and 1024 rows (where the tree has it) beside two
``torch.matmul`` calls; the int8 boundary at the stream's 4, 32 and
128 rows (rank 384, bf16): encode + quantize and dequantize + decode fused
(where the tree has them) and composed from the standalone kernels; and the
slab store's column quantization (wi, wo at 1 and 3 slabs, f32).  ``--src`` names the ``src`` directory whose
``repro_torch`` is timed, so that two trees are compared in one run on one
card (one process a tree):

    python tools/kernel_probe.py [--src DIR] [--tag NAME] [--mma-sync] [--gate-generic]
                                 [--only SECTION ...]

Prints the card's ``nvidia-smi`` name and power limit, then one line per
reading.  Needs a CUDA device; builds nothing at import.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    FFN_CASES,
    PA_CASES,
    RESIDENT_CASES,
    RESIDENT_QUANT_CASES,
    WIDE_FFN_CASES,
    Timer,
    ffn_yardsticks,
    nvidia_smi,
    paged_attention_inputs,
    resident_store,
    short_names,
    switch_base_moe,
    wide_ffn_weights,
)

CODEC_ROWS = (4, 32, 1024)
ROUNDTRIP_PROBE_ROWS = (4, 8, 32, 1024)  # the stream's group, serving decode, a chunk, run_batch
GATE_ROWS = (4, 8, 256, 1024)


def host_us(torch, fn, iters=300):
    """(median, 10th percentile) of the host time (us) of one call of
    ``fn``, the stream idle at each call's start."""
    times = []
    for _ in range(iters + 10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    times = sorted(times[10:])
    return statistics.median(times) * 1e6, times[len(times) // 10] * 1e6


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def launches_per_call(torch, fn, iters: int = 10) -> float:
    """Device kernels (copies and fills included) one call of ``fn``
    launches, counted by ``torch.profiler`` over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU)
        if n:
            break
    return n / iters


def warm_device_us(torch, fn, iters: int = 20) -> float:
    """Mean device time (us) of the kernels one call of ``fn`` launches,
    without the L2 flush between calls (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / iters


class Probe:
    def __init__(self, torch, tag: str):
        self.torch, self.tag = torch, tag
        self.timer = Timer(torch)

    def reading(self, what, fn, plain, yardsticks=(), view=_flat):
        """One wrapper call ``fn`` against ``plain`` (each output through
        ``view`` first), the device kernels a call launches, and the device
        time a call of each ``(name, callable)`` yardstick."""
        torch = self.torch
        out = [a.clone() for a in view(fn())]
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(out, view(plain())) if a.numel())
        same = all(all(torch.equal(a, b) for a, b in zip(view(fn()), out)) for _ in range(3))
        dev, keys = self.timer.device_us(fn)
        host, p10 = host_us(torch, fn)
        print(f"kernel_probe {self.tag} {what}: device_us={dev:.3f} host_us={host:.3f} "
              f"host_p10_us={p10:.3f} max_abs_err={err:.3e} equal_bits={same} "
              f"launches_per_call={launches_per_call(torch, fn):g} "
              f"kernels=[{short_names(keys)}]", flush=True)
        for name, y in yardsticks:
            line = y() if name is None else f"{name} {self.timer.device_us(y)[0]:.3f}"
            print(f"kernel_probe {self.tag} yardstick ({what}): {line}", flush=True)


def build_mma_sync() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libcodec_mma_sync.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(ROOT / "src/repro_torch/csrc"),
                    "-o", str(lib), str(ROOT / "tools/codec_mma_sync.cu")], check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.codec_mma_sync_launch.restype = ctypes.c_int
    cdll.codec_mma_sync_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return cdll


def codec(pr: Probe, mma_sync: bool):
    from repro_torch.kernels.lowrank import lowrank_decode, lowrank_encode, lowrank_project_plain

    torch = pr.torch
    mma = build_mma_sync() if mma_sync else None
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.linalg.qr(torch.randn(768, 384, generator=g, device="cuda"))[0]
    enc, dec = q.bfloat16().contiguous(), q.T.bfloat16().contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    for T in CODEC_ROWS:
        x = torch.randn(T, 768, generator=g, device="cuda").bfloat16()
        z = lowrank_project_plain(x, enc)
        for what, fn, a, w in (("encode", lowrank_encode, x, enc),
                               ("decode", lowrank_decode, z, dec)):
            pr.reading(f"lowrank_{what} T={T}", functools.partial(fn, a, w),
                       functools.partial(lowrank_project_plain, a, w),
                       [("torch.matmul", functools.partial(torch.matmul, a, w))])
            if mma is None:
                continue
            y = torch.empty(a.shape[0], w.shape[1], dtype=a.dtype, device="cuda")

            def call(a=a, w=w, y=y):
                if mma.codec_mma_sync_launch(a.data_ptr(), w.data_ptr(), y.data_ptr(),
                                             a.shape[0], a.shape[1], w.shape[1], stream):
                    raise RuntimeError("codec_mma_sync_launch failed")
                return y

            pr.reading(f"codec_mma_sync {what} T={T}", call,
                       functools.partial(lowrank_project_plain, a, w))


def generic_gate_form(call):
    """``call`` with the gate's launch plan forced to its generic form (form
    0: one float a weight load), the tokens and threads a block unchanged."""
    from repro_torch.kernels.group_gate import ops

    plan = ops.launch_plan

    def forced():
        ops.launch_plan = lambda *a, **kw: (0, *plan(*a, **kw)[1:])
        try:
            return call()
        finally:
            ops.launch_plan = plan
    return forced


def flash_and_gate(pr: Probe, gate_generic: bool = False):
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.gating import init_group_gate
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain
    from repro_torch.kernels.group_gate import group_gate, group_gate_plain

    torch = pr.torch
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(4, 256, 12, 64, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pr.reading("flash_attention [4,256,12,64] causal",
               functools.partial(flash_attention_fwd, q, k, v),
               functools.partial(flash_attention_plain, q, k, v),
               [("sdpa", functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                           is_causal=True))])
    for model, rows in (("switch-base", GATE_ROWS), ("llama4-scout-17b-16e", (8, 1024))):
        cfg = get_config(model)
        p = init_group_gate(g, cfg.d_model, cfg.moe)
        mask = torch.arange(cfg.moe.num_experts, device="cuda") % 3 != 1  # a partial mask
        for T in rows:
            x = torch.randn(T, cfg.d_model, generator=g, device="cuda").bfloat16()
            for m in (None, mask) if T == 8 else (None,):
                args = (x, p["w_local"], p["b_local"], p["w_global"], p["b_global"], m)
                call = functools.partial(group_gate, *args)
                what = f"group_gate {model} d={cfg.d_model} T={T}" + (
                    " masked" if m is not None else "")
                for form, fn in (("", call), *((" generic form", generic_gate_form(call)),)
                                 * gate_generic):
                    pr.reading(what + form, fn, functools.partial(group_gate_plain, *args),
                               [(None, lambda fn=fn: f"the call without the L2 flush "
                                                     f"{warm_device_us(torch, fn):.3f}")])


def kv_writes(pr: Probe):
    """One int8 layer write of the streaming engine (``_write_kv`` through
    ``kvcache.paged_ring_write_quant`` / ``paged_write_tokens_quant``): a
    decode group (4 slots, one token each, one slot past a ring wrap) and a
    prefill chunk (1 slot, 32 rows, 7 of them padding), k and v of 12 heads
    of 64 in bf16 into int8 pools of 128 pages of 16 tokens (a view of a
    6-block leaf, as the engine holds them), against the same writers on
    the CPU outside the garbage row."""
    from repro_torch.models import kvcache

    torch = pr.torch
    g = torch.Generator(device="cuda").manual_seed(9)
    P, ps, KV, hd, pps, R = 128, 16, 12, 64, 16, 6
    leaves = [torch.zeros(R, P + 1, ps, KV, hd, dtype=torch.int8, device="cuda") for _ in "kv"]
    scales = [torch.zeros(R, P + 1, ps, dtype=torch.float16, device="cuda") for _ in "kv"]
    pools = (leaves[0][2], leaves[1][2], scales[0][2], scales[1][2])
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(9)).int()
    for name, B, C, n_valid, lengths in (("decode B=4 C=1", 4, 1, None, (37, 118, 199, 300)),
                                         ("prefill chunk B=1 C=32", 1, 32, 25, (96,))):
        table = perm[:B * pps].view(B, pps).cuda()
        k, v = (torch.randn(B, C, KV, hd, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        if C == 1:
            args = (k, v, table, lengths, ps)
            write = kvcache.paged_ring_write_quant
        else:
            pos = (lengths[:, None] + torch.arange(C, device="cuda")[None]).int()
            valid = torch.arange(C, device="cuda")[None] < n_valid
            args = (k, v, table, pos, valid, ps)
            write = kvcache.paged_write_tokens_quant
        cpu_pools = tuple(t.cpu() for t in pools)

        def plain(write=write, args=args, cpu_pools=cpu_pools):
            return tuple(t.cuda() for t in write(*cpu_pools, *(
                a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))

        call = functools.partial(write, *pools, *args)
        pr.reading(f"int8 KV layer write {name}", call, plain,
                   [(None, lambda call=call: f"the call without the L2 flush "
                                             f"{warm_device_us(torch, call):.3f}")],
                   view=lambda out: [t[:-1] for t in out])


def paged(pr: Probe):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        paged_attention,
        paged_attention_plain,
        paged_attention_quant,
    )
    from repro_torch.models.kvcache import (
        dequantize_kv_pool,
        paged_gather,
        quantize_kv_tokens,
        ring_key_positions,
    )

    torch = pr.torch
    # PA_CASES, and the streaming engine's group as chip_smoke.py's stream
    # phase runs it (max_len 256: 16-page rings)
    cases = PA_CASES + (("B=4 pps=16 C=1", 4, 16, 1, (57, 130, 171, 222)),)
    for i, (name, B, pps, C, anchors) in enumerate(cases):
        q, pk, pv, table, q_pos, lengths = paged_attention_inputs(
            torch, C, C + (100 if i >= 2 else 0), B=B, pps=pps, lengths=anchors)
        kq, ks = quantize_kv_tokens(pk)
        vq, vs = quantize_kv_tokens(pv)
        kp = ring_key_positions(lengths, pk.shape[1] * pps)
        mask = ((kp[:, None, :] <= q_pos[:, :, None].long()) & (kp[:, None, :] >= 0))[:, None]
        qd = q.transpose(1, 2)
        for what, fn, plain, rk, rv in (
                ("paged_attention", functools.partial(paged_attention, q, pk, pv, table, q_pos,
                                                      lengths),
                 functools.partial(paged_attention_plain, q, pk, pv, table, q_pos, lengths),
                 pk, pv),
                ("paged_attention_quant",
                 functools.partial(paged_attention_quant, q, kq, vq, ks, vs, table, q_pos,
                                   lengths),
                 functools.partial(paged_attention_plain, q, kq, vq, table, q_pos, lengths,
                                   k_scale=ks, v_scale=vs),
                 dequantize_kv_pool(kq, ks, torch.bfloat16),
                 dequantize_kv_pool(vq, vs, torch.bfloat16))):
            kd = paged_gather(rk, table).transpose(1, 2)
            vd = paged_gather(rv, table).transpose(1, 2)
            pr.reading(f"{what} {name}", fn, plain,
                       [("sdpa", functools.partial(F.scaled_dot_product_attention, qd, kd, vd,
                                                   attn_mask=mask))])


def expert_ffn(pr: Probe):
    from repro_torch.kernels.expert_mlp import (
        grouped_mlp,
        grouped_mlp_plain,
        grouped_mlp_resident,
        grouped_mlp_resident_plain,
        grouped_mlp_resident_quant,
        grouped_mlp_resident_quant_plain,
    )

    torch = pr.torch
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(2)
    p, cfg = switch_base_moe(gen)
    E, d, f = p["wi"].shape
    wg = (torch.randn(E, d, f, generator=gen, device="cuda") / E ** 0.5).bfloat16()
    for name, sizes, act, gated, dt in FFN_CASES:
        wi, wo = p["wi"].to(dts[dt]), p["wo"].to(dts[dt])
        wg_ = wg if gated else None
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        xs = torch.randn(sum(sizes), d, generator=gen, device="cuda").to(dts[dt])
        args = (xs, gs, wi, wg_, wo, act)
        pr.reading(f"grouped_mlp {name}", functools.partial(grouped_mlp, *args),
                   functools.partial(grouped_mlp_plain, *args),
                   [(None, functools.partial(ffn_yardsticks, torch, pr.timer, xs, sizes, wi, wg_,
                                             wo, act))])
    w = wide_ffn_weights(torch, gen)
    for name, sizes in WIDE_FFN_CASES:
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        xs = torch.randn(sum(sizes), w["wi"].shape[1], generator=gen, device="cuda").bfloat16()
        args = (xs, gs, w["wi"], w["wg"], w["wo"], "silu")
        pr.reading(f"grouped_mlp {name}", functools.partial(grouped_mlp, *args),
                   functools.partial(grouped_mlp_plain, *args),
                   [(None, functools.partial(ffn_yardsticks, torch, pr.timer, xs, sizes,
                                             w["wi"], w["wg"], w["wo"], "silu"))])
    del w

    gen = torch.Generator(device="cuda").manual_seed(5)
    p, cfg = switch_base_moe(gen)
    for quant, cases in ((False, RESIDENT_CASES), (True, RESIDENT_QUANT_CASES)):
        store = resident_store(torch, p, quant=quant)
        kw = (dict(wi_scale=store["wi_scale"], wg_scale=None, wo_scale=store["wo_scale"])
              if quant else {})
        fn, plain = ((grouped_mlp_resident_quant, grouped_mlp_resident_quant_plain) if quant
                     else (grouped_mlp_resident, grouped_mlp_resident_plain))
        for name, dt, sizes, ids in cases:
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            idt = torch.tensor(ids, dtype=torch.int32, device="cuda")
            xs = torch.randn(sum(sizes), d, generator=gen, device="cuda").to(dts[dt])
            args = (xs, gs, store["wi"], None, store["wo"], idt, cfg.act)
            pr.reading(f"{fn.__name__} {'int8' if quant else 'f32'} store {name}",
                       functools.partial(fn, *args, **kw), functools.partial(plain, *args, **kw))


def quant_and_roundtrip(pr: Probe):
    from repro_torch.kernels.lowrank import lowrank_roundtrip, lowrank_roundtrip_plain
    from repro_torch.kernels.quant import (
        dequantize_rows,
        dequantize_rows_plain,
        quantize_rows,
        quantize_rows_plain,
    )

    torch = pr.torch
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, shape, sdt in (("boundary 4x384", (4, 384), torch.float16),):
        x = torch.randn(*shape, generator=g, device="cuda").bfloat16()
        pr.reading(f"quantize_rows {name}",
                   functools.partial(quantize_rows, x, scale_dtype=sdt),
                   functools.partial(quantize_rows_plain, x, scale_dtype=sdt))
        c, s = quantize_rows_plain(x, scale_dtype=sdt)
        pr.reading(f"dequantize_rows {name}", functools.partial(dequantize_rows, c, s),
                   functools.partial(dequantize_rows_plain, c, s))
    q = torch.linalg.qr(torch.randn(768, 384, generator=g, device="cuda"))[0]
    enc, dec = q.bfloat16().contiguous(), q.T.bfloat16().contiguous()
    x = torch.randn(1000, 768, generator=g, device="cuda").bfloat16()
    pr.reading("lowrank_roundtrip T=1000", functools.partial(lowrank_roundtrip, x, enc, dec),
               functools.partial(lowrank_roundtrip_plain, x, enc, dec))
    from repro_torch.kernels import lowrank as lr

    if not hasattr(lr, "lowrank_roundtrip_loss"):  # a tree before the dispatch codec
        return
    for T in ROUNDTRIP_PROBE_ROWS:  # the MoE dispatch codec's form
        xt = torch.randn(T, 768, generator=g, device="cuda").bfloat16()
        pr.reading(f"lowrank_roundtrip_loss T={T}",
                   functools.partial(lr.lowrank_roundtrip_loss, xt, enc, dec),
                   functools.partial(lr.lowrank_roundtrip_loss_plain, xt, enc, dec),
                   [("torch.matmul pair", lambda xt=xt: torch.matmul(torch.matmul(xt, enc), dec))])


def codec_quant(pr: Probe):
    """The boundary's int8 stage beside the codec, fused (this tree's
    ``lowrank_encode_quant`` / ``lowrank_decode_quant``, if it has them)
    and composed from the standalone kernels (any tree), at the stream's
    rows; then the slab columns."""
    from repro_torch.kernels import lowrank as lr
    from repro_torch.kernels.quant import (
        dequantize_rows,
        quantize_rows,
        quantize_rows_plain,
    )

    torch = pr.torch
    g = torch.Generator(device="cuda").manual_seed(5)
    d, r, f16 = 768, 384, torch.float16
    q = torch.linalg.qr(torch.randn(d, r, generator=g, device="cuda"))[0]
    enc, dec = q.bfloat16().contiguous(), q.T.bfloat16().contiguous()
    fused = hasattr(lr, "lowrank_encode_quant")
    for T in (4, 32, 128):
        x = torch.randn(T, d, generator=g, device="cuda").bfloat16()
        codes, scale = quantize_rows(lr.lowrank_encode(x, enc), scale_dtype=f16)

        def enc_composed(x=x):
            return quantize_rows(lr.lowrank_encode(x, enc), scale_dtype=f16)

        def dec_composed(codes=codes, scale=scale):
            return lr.lowrank_decode(dequantize_rows(codes, scale, dtype=torch.bfloat16), dec)

        def enc_plain(x=x):
            return quantize_rows_plain(lr.lowrank_project_plain(x, enc), scale_dtype=f16)

        def dec_plain(codes=codes, scale=scale):
            return lr.lowrank_project_plain((codes.float() * scale.float()).bfloat16(), dec)

        pr.reading(f"encode + quantize composed T={T}", enc_composed, enc_plain)
        pr.reading(f"dequantize + decode composed T={T}", dec_composed, dec_plain)
        if not fused:
            continue
        pr.reading(f"lowrank_encode_quant T={T}",
                   functools.partial(lr.lowrank_encode_quant, x, enc), enc_plain,
                   [("torch.matmul (the product alone)", functools.partial(torch.matmul, x, enc))])
        pr.reading(f"lowrank_decode_quant T={T}",
                   functools.partial(lr.lowrank_decode_quant, codes, scale, dec), dec_plain,
                   [("torch.matmul (the product alone)",
                     functools.partial(torch.matmul, codes.bfloat16(), dec))])
    for outer in (1, 3):
        for name, shape in (("wi", (768, 3072)), ("wo", (3072, 768))):
            w = torch.randn(outer, *shape, generator=g, device="cuda") * 0.02
            pr.reading(f"quantize_rows slab {name} columns outer={outer}",
                       functools.partial(quantize_rows, w, axis=-2),
                       functools.partial(quantize_rows_plain, w, axis=-2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to time")
    ap.add_argument("--tag", default="tree", help="a name for this tree in the output")
    ap.add_argument("--mma-sync", action="store_true", help="also time the codec's mma.sync form")
    ap.add_argument("--gate-generic", action="store_true",
                    help="also time each gate case with its generic form forced")
    ap.add_argument("--only", nargs="+", choices=sorted(SECTIONS),
                    help="read only these sections (default: all, in order)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    print(nvidia_smi(), flush=True)
    pr = Probe(torch, args.tag)
    for name, section in SECTIONS.items():
        if args.only is None or name in args.only:
            section(pr, args)
    return 0


# the readings in order: name -> fn(probe, args)
SECTIONS = {
    "codec": lambda pr, args: codec(pr, args.mma_sync),
    "flash_and_gate": lambda pr, args: flash_and_gate(pr, args.gate_generic),
    **{f.__name__: (lambda f: lambda pr, _: f(pr))(f)
       for f in (kv_writes, paged, expert_ffn, quant_and_roundtrip, codec_quant)},
}


if __name__ == "__main__":
    sys.exit(main())
