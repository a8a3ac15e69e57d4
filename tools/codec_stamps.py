"""Phase stamps of the fused boundary encode (``lowrank_encode_quant``) on
the card: ``%globaltimer`` read by thread 0 of every block at the
kernel's entry, after the projection's mainloop, after the cluster wait,
after the cluster barrier and at the end.  The stamps live in a copy of
``src/repro_torch`` whose ``csrc/lowrank.cu`` records them (under
``build/stamps/``, built there; the package's own library is untouched).

Prints, for 4, 32 and 128 rows of rank 384 alone (the L2 flushed before
each call, the median over 10 calls of each phase's latest block), and
for the encode launches of the int8 streaming engine's decode ticks
(``chip_smoke.py``'s quant pool scenario: full-width switch-base, all
three int8 streams), each phase's time from the first block's entry, the
earliest and latest block, in ns:

    python tools/codec_stamps.py

Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "stamps"
PHASES = {0: "entry", 2: "mainloop", 4: "cluster wait", 5: "cluster barrier", 3: "end"}

STAMP = """__device__ unsigned long long g_stamps[8][256];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[k][blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}
"""
READ = """
extern "C" int read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
"""
# (anchor in csrc/lowrank.cu, its stamped form): each must match once
EDITS = (
    ("namespace {\n", STAMP + "namespace {\n"),
    ("  q8::cluster_arrive();  // met in quant_tile",
     "  stamp(0);\n  q8::cluster_arrive();  // met in quant_tile"),
    ("  quant_tile(d, q, scale, r0, c0, nt, n, kTma);",
     "  stamp(2);\n  quant_tile(d, q, scale, r0, c0, nt, n, kTma);\n  stamp(3);"),
    ("  q8::cluster_wait();\n  if (writer) {", "  q8::cluster_wait();\n  stamp(4);\n  if (writer) {"),
    ("  cluster.sync();\n  const int cs", "  cluster.sync();\n  stamp(5);\n  const int cs"),
)


def stamped_package():
    """``build/stamps/repro_torch``: the package with the stamped codec."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "repro_torch")
    path = COPY / "repro_torch" / "csrc" / "lowrank.cu"
    src = path.read_text()
    for anchor, stamped in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"codec_stamps: {anchor!r} is not in lowrank.cu once")
        src = src.replace(anchor, stamped)
    path.write_text(src + READ)
    sys.path.insert(0, str(COPY))


def phases(torch, lib, blocks: int):
    """{phase: (earliest, latest block) ns from the first entry} of the
    last launch."""
    import numpy as np

    torch.cuda.synchronize()
    buf = np.zeros((8, 256), np.uint64)
    if lib.read_stamps(buf.ctypes.data):
        raise RuntimeError("codec_stamps: reading the stamps failed")
    b = buf[:, :blocks].astype(np.int64)
    t0 = b[0].min()
    return {name: (int((b[k] - t0).min()), int((b[k] - t0).max())) for k, name in PHASES.items()}


def line(what, ph):
    return f"codec_stamps {what}: " + " ".join(f"{k} {a}-{b}" for k, (a, b) in ph.items())


def main() -> int:
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("codec_stamps: no CUDA device", file=sys.stderr)
        return 2
    stamped_package()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import PROFILES
    from repro_torch.kernels.lowrank import ops as lr
    from repro_torch.models.model import Model

    lib = lr._lib()
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    print(cs.nvidia_smi(), flush=True)
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    enc = torch.linalg.qr(torch.randn(768, 384, generator=g, device="cuda"))[0]
    enc = enc.bfloat16().contiguous()
    for T in (4, 32, 128):
        x = torch.randn(T, 768, generator=g, device="cuda").bfloat16()
        call = functools.partial(lr.lowrank_encode_quant, x, enc)
        runs = []
        for _ in range(13):
            timer.flush_buf.zero_()
            call()
            runs.append(phases(torch, lib, 6 * -(-T // 64)))
        med = {k: (int(statistics.median(r[k][0] for r in runs[3:])),
                   int(statistics.median(r[k][1] for r in runs[3:]))) for k in runs[0]}
        print(line(f"alone T={T} (L2 flushed, median of 10)", med), flush=True)

    model = Model(get_config("switch-base"), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = cs.stream_engine(model, params, PROFILES["jetson-orin"], force_split=1,
                           timing="measured", **cs.QUANT)
    for r in cs.stream_requests(model.cfg.vocab_size, 8, 0, 32):
        eng.submit(r)
    tick = 0
    while eng.busy() and tick < 40:
        eng.step()
        decoding = not eng._jobs and not eng.waiting and int(eng._active.sum()) == 8
        if tick > 20 and decoding and tick % 4 == 0:  # the tick's last encode: 4 rows
            print(line(f"in the int8 stream, tick {tick}", phases(torch, lib, 6)), flush=True)
        tick += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
