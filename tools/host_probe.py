"""Host time of the one-shot pipeline's tiers and wrappers on the card.

Every path of the port is host-bound: the host enqueues a tier's kernels
more slowly than the card runs them.  ``chip_smoke.py`` reads each tier of
``EndCloudPipeline.run_batch`` as one host-clock span around it, median of
10 runs, after its other phases.  This script reads the same tiers alone, on
full-width switch-base with random weights from seed 0 and tokens [4, 256]
(the jetson-orin end and a100 cloud of ``chip_smoke.py``: split 1, codec
rank 384), over 40 runs after 3 warm-ups, split in two:

- ``host``: from the tier's start until its last kernel is enqueued;
- ``wall``: until the device has finished it (what ``run_batch`` reports).

It also reads the host time of one call of the flash-attention and codec
wrappers (and of ``torch.matmul``) with the stream idle and with the
stream busy (a ~2.6 ms sleep kernel queued first): a wrapper that waits for
the device reads the sleep in its busy time.  ``--src`` names the ``src``
directory whose ``repro_torch`` is timed, so that two trees can be compared
on one card, one process each:

    python tools/host_probe.py [--src DIR] [--tag NAME]

With ``--serve DIR`` it reads the serving engine instead: ``DIR``'s
``chip_smoke.py`` runs its kernel checks (phase 2) and then its serving
phase (``serve``: 8 requests, the decode-step median over 30 steps on the
host clock), with ``repro_torch`` from ``--src``; so the same engine can be
read after either tree's script, one process a reading:

    python tools/host_probe.py --serve DIR [--src DIR] [--tag NAME]

Prints the card's ``nvidia-smi`` name and power limit, then one line per
reading (median, and first and third quartiles or 10th percentile).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def call_host_us(torch, fn, busy: bool, iters: int = 200) -> str:
    """Median / 10th percentile host time (us) of one call of ``fn``; with
    ``busy``, a sleep kernel is queued before each call."""
    times = []
    for _ in range(iters + 10):
        torch.cuda.synchronize()
        if busy:
            torch.cuda._sleep(4_000_000)
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    times = sorted(times[10:])
    return f"{statistics.median(times) * 1e6:.1f} / {times[len(times) // 10] * 1e6:.1f}"


def serve(torch, script_dir: Path, tag: str) -> int:
    """``script_dir``'s ``chip_smoke.py``: its kernel checks, then its
    serving phase, which logs the decode-step median."""
    sys.path.insert(1, str(script_dir))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.expert_mlp import grouped_mlp
    from repro_torch.kernels.group_gate import group_gate
    from repro_torch.kernels.paged_attention import paged_attention

    print(f"host_probe {tag} serve: script {script_dir}, src "
          f"{Path(build.__file__).parents[2]}", flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    build.build()
    timer = cs.Timer(torch)
    for check in (cs.run_paged_attention, cs.run_group_gate, cs.run_expert_mlp,
                  cs.run_expert_mlp_resident, cs.run_flash_attention, cs.run_lowrank):
        check(torch, timer)
    cs.serve(torch, [paged_attention, group_gate, grouped_mlp])
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to time")
    ap.add_argument("--tag", default="tree", help="a name for this tree in the output")
    ap.add_argument("--serve", metavar="DIR",
                    help="read the serving phase of DIR/chip_smoke.py instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("host_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.serve:
        return serve(torch, Path(args.serve).resolve(), args.tag)
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import PROFILES
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.lowrank import lowrank_encode
    from repro_torch.models.model import Model
    from repro_torch.serving import EndCloudPipeline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 256, 12, 64, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    enc = torch.randn(768, 384, generator=g, device="cuda").bfloat16()
    x = torch.randn(1024, 768, generator=g, device="cuda").bfloat16()
    x4 = x[:4].contiguous()
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(4_000_000)
    torch.cuda.synchronize()
    print(f"host_probe {args.tag} busy stream: a sleep of "
          f"{(time.perf_counter() - t) * 1e3:.3f} ms", flush=True)
    for name, fn in (("flash_attention_fwd [4,256,12,64]",
                      lambda: flash_attention_fwd(q, k, v, causal=True)),
                     ("lowrank_encode T=1024", lambda: lowrank_encode(x, enc)),
                     ("lowrank_encode T=4", lambda: lowrank_encode(x4, enc)),
                     ("torch.matmul T=1024", lambda: torch.matmul(x, enc))):
        print(f"host_probe {args.tag} {name}: host us a call, median / p10: idle "
              f"{call_host_us(torch, fn, False)}, busy {call_host_us(torch, fn, True)}",
              flush=True)

    cfg = get_config("switch-base")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    pipe = EndCloudPipeline(model, params, compression_rank=384,
                            end_profile=PROFILES["jetson-orin"], cloud_profile=PROFILES["a100"])
    tok = torch.randint(0, cfg.vocab_size, (4, 256), generator=g, device="cuda")
    for _ in range(3):
        pipe.run_batch(tok)
    rows = []
    for _ in range(40):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = pipe._end_forward(tok)
        h_end = time.perf_counter() - t0
        torch.cuda.synchronize()
        w_end = time.perf_counter() - t0
        t1 = time.perf_counter()
        pipe._cloud_forward(z)
        h_cloud = time.perf_counter() - t1
        torch.cuda.synchronize()
        rows.append((h_end, w_end, h_cloud, time.perf_counter() - t1))
    for i, what in enumerate(("end tier host", "end tier wall", "cloud tier host",
                              "cloud tier wall")):
        ms = sorted(r[i] * 1e3 for r in rows)
        print(f"host_probe {args.tag} {what}: median {ms[20]:.3f} ms, q1 {ms[10]:.3f}, "
              f"q3 {ms[30]:.3f} over 40 runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
