"""Time the codec projection on the card, per call, on and off the device.

For encode (``X [T, 768] · E [768, 384]``) and decode (``Z [T, 384] ·
D [384, 768]``) in bf16 at the row counts the engines give them (4 and 32:
the streaming engine's decode group step and prefill chunk; 1024: the
one-shot pipeline's [4, 256] batch), it reads for the port's wrappers
``lowrank_encode`` / ``lowrank_decode`` and for ``torch.matmul``:

- ``device_us``: the device time of every kernel one call launches, mean
  over 50 calls with the L2 flushed before each (``torch.profiler``; nan
  where the profiler recorded none of them);
- ``host_us``, ``host_p10_us``: the host time of one call, median and
  10th percentile over 300 calls, each started on an idle stream (the
  launch is asynchronous, so this is the Python, the checks, the
  allocation and the launch API; the percentile is the less disturbed by
  other work on a shared host);

and with ``--mma-sync`` the device time of ``tools/codec_mma_sync.cu``, the
``mma.sync`` form the wgmma kernel was chosen over, built here with nvcc.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed, so
that two trees can be compared in one run on one card:

    python tools/codec_probe.py [--src DIR] [--tag NAME] [--mma-sync]

Prints the card's ``nvidia-smi`` name and power limit, then one line per
reading.  Needs a CUDA device; builds nothing at import.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D, R = 768, 384
ROWS = (4, 32, 1024)


def device_us(torch, fn, flush, iters=50):
    """Mean device time (us) of the kernels one call of ``fn`` launches,
    each call after an L2 flush; and those kernels' names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as solo:
        fn()
        torch.cuda.synchronize()
    keys = {e.key for e in kernels(solo)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    mine = [e for e in kernels(prof) if e.key in keys]
    if not mine:  # the profiler recorded no kernel of the call: not measured
        return float("nan"), sorted(keys)
    return sum(e.self_device_time_total for e in mine) / iters, sorted(keys)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to time")
    ap.add_argument("--tag", default="tree", help="a name for this tree in the output")
    ap.add_argument("--mma-sync", action="store_true", help="also time the mma.sync form")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("codec_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.lowrank import lowrank_decode, lowrank_encode, lowrank_project_plain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    mma = build_mma_sync() if args.mma_sync else None
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.linalg.qr(torch.randn(D, R, generator=g, device="cuda"))[0]
    enc, dec = q.bfloat16().contiguous(), q.T.bfloat16().contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    for T in ROWS:
        x = torch.randn(T, D, generator=g, device="cuda").bfloat16()
        z = lowrank_project_plain(x, enc)
        for what, fn, a, w in (("encode", lowrank_encode, x, enc),
                               ("decode", lowrank_decode, z, dec)):
            ref = lowrank_project_plain(a, w).float()
            out = fn(a, w)
            err = (out.float() - ref).abs().max().item()
            same = all(torch.equal(fn(a, w), out) for _ in range(3))
            dev, keys = device_us(torch, lambda: fn(a, w), flush)
            host, p10 = host_us(torch, lambda: fn(a, w))
            print(f"codec_probe {args.tag} {what} T={T}: device_us={dev:.3f} host_us={host:.3f} "
                  f"host_p10_us={p10:.3f} max_abs_err={err:.3e} equal_bits={same} "
                  f"kernels={keys}", flush=True)
            dev, keys = device_us(torch, lambda: torch.matmul(a, w), flush)
            host, p10 = host_us(torch, lambda: torch.matmul(a, w))
            print(f"codec_probe {args.tag} matmul {what} T={T}: device_us={dev:.3f} "
                  f"host_us={host:.3f} host_p10_us={p10:.3f} kernels={keys}", flush=True)
            if mma is None:
                continue
            y = torch.empty_like(out)
            nt, k = a.shape

            def call():
                if mma.codec_mma_sync_launch(a.data_ptr(), w.data_ptr(), y.data_ptr(), nt, k,
                                             w.shape[1], stream):
                    raise RuntimeError("codec_mma_sync_launch failed")

            call()
            torch.cuda.synchronize()
            err = (y.float() - ref).abs().max().item()
            dev, _ = device_us(torch, call, flush)
            print(f"codec_probe mma_sync {what} T={T}: device_us={dev:.3f} "
                  f"max_abs_err={err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
