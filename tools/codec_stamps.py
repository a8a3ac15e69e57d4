"""Phase stamps of the codec's cluster kernels on the card:
``%globaltimer`` read by thread 0 of every block at the phases of a
launch.  The stamps live in a copy of ``src/repro_torch`` whose
``csrc/lowrank.cu`` records them (under ``build/stamps/``, built there;
the package's own library is untouched).

The fused boundary encode (``lowrank_encode_quant``, the default): the
kernel's entry, after the projection's mainloop, after the cluster wait,
after the cluster barrier and at the end; for 4, 32 and 128 rows of rank
384 alone (the L2 flushed before each call, the median over 10 calls of
each phase's latest block), and for the encode launches of the int8
streaming engine's decode ticks (``chip_smoke.py``'s quant pool scenario:
full-width switch-base, all three int8 streams).

``--roundtrip``: the MoE dispatch codec's roundtrip
(``lowrank_roundtrip_loss``, bf16): entry, Z's tile done (phase 1), the
cluster wait, the exchanges done (the partner's partial and the other Z
tiles landed), X̂'s tiles
done (phase 2) and the end (after the error's cluster barrier and, in
rank 0, the sums); block 0's ring steps (each step's slot landed, the
previous step's products done); for 8 and 1024 rows alone, and for the last roundtrip of the
serving decode steps of ``chip_smoke.py``'s dispatch codec run (8 rows).

Each line gives each phase's time from the first block's entry, the
earliest and latest block, in ns:

    python tools/codec_stamps.py [--roundtrip]

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
RT_PHASES = {0: "entry", 1: "phase 1", 2: "cluster wait", 3: "exchanges", 4: "phase 2", 5: "end"}

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
READ_STEPS = """
extern "C" int read_steps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_steps, sizeof(g_steps));
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

# block 0's ring steps: k = 2g when step g's slot has landed, 2g + 1 when
# step g - 1's products are done
STEP_STAMP = """__device__ unsigned long long g_steps[64];
__device__ __forceinline__ void step_stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && k < 64) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_steps[k] = t;
  }
}
"""
# the roundtrip's bf16 kernel (the f32 kernel's lines differ around them)
RT_EDITS = (
    ("namespace {\n", STAMP + STEP_STAMP + "namespace {\n"),
    ("    if constexpr (kTma) tc::mbar_wait(&full[sl], (g / kRtStages) & 1);\n",
     "    if constexpr (kTma) tc::mbar_wait(&full[sl], (g / kRtStages) & 1);\n"
     "    step_stamp(2 * g);\n"),
    ("    tc::wgmma_wait<1>();  // step g - 1's products are done (step g's run on)\n"
     "    if (g + kRtStages - 1 < total) {\n",
     "    tc::wgmma_wait<1>();  // step g - 1's products are done (step g's run on)\n"
     "    step_stamp(2 * g + 1);\n"
     "    if (g + kRtStages - 1 < total) {\n"),
    ("  bf16* ring = ring_base(smem_raw);", "  stamp(0);\n  bf16* ring = ring_base(smem_raw);"),
    ("  if (split > 1) {\n#pragma unroll\n    for (int q = 0; q < 32; ++q) pout[",
     "  stamp(1);\n  if (split > 1) {\n#pragma unroll\n    for (int q = 0; q < 32; ++q) pout["),
    ("  q8::cluster_wait();  // every peer has started and initialised its mbarriers\n",
     "  q8::cluster_wait();  // every peer has started and initialised its mbarriers\n"
     "  stamp(2);\n"),
    ("  tc::mbar_wait(&zfull, 0);  // the other tiles have landed: the whole Z row tile\n",
     "  tc::mbar_wait(&zfull, 0);  // the other tiles have landed: the whole Z row tile\n"
     "  stamp(3);\n"),
    ("  // this block runs once it passes\n  cluster_error(sq, partial, ticket, err, count);\n",
     "  // this block runs once it passes\n  stamp(4);\n"
     "  cluster_error(sq, partial, ticket, err, count);\n  stamp(5);\n"),
)


def stamped_package(edits=EDITS):
    """``build/stamps/repro_torch``: the package with the stamped codec."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "repro_torch")
    path = COPY / "repro_torch" / "csrc" / "lowrank.cu"
    src = path.read_text()
    for anchor, stamped in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"codec_stamps: {anchor!r} is not in lowrank.cu once")
        src = src.replace(anchor, stamped)
    path.write_text(src + READ + (READ_STEPS if "g_steps" in src else ""))
    sys.path.insert(0, str(COPY))


def phases(torch, lib, blocks: int, names=PHASES):
    """{phase: (earliest, latest block) ns from the first entry} of the
    last launch."""
    import numpy as np

    torch.cuda.synchronize()
    buf = np.zeros((8, 256), np.uint64)
    if lib.read_stamps(buf.ctypes.data):
        raise RuntimeError("codec_stamps: reading the stamps failed")
    b = buf[:, :blocks].astype(np.int64)
    t0 = b[0].min()
    return {name: (int((b[k] - t0).min()), int((b[k] - t0).max())) for k, name in names.items()}


def line(what, ph):
    return f"codec_stamps {what}: " + " ".join(f"{k} {a}-{b}" for k, (a, b) in ph.items())


def lib_stamps(lib):
    """Block 0's entry stamp of the last launch (the steps' origin)."""
    import numpy as np

    buf = np.zeros((8, 256), np.uint64)
    lib.read_stamps(buf.ctypes.data)
    return int(buf[0, 0])


def steps_line(torch, lib, what, t0: int) -> str:
    """Block 0's ring steps of the last launch, ns from its entry: each step
    as (its slot landed, the previous step's products done)."""
    import numpy as np

    torch.cuda.synchronize()
    buf = np.zeros(64, np.uint64)
    if lib.read_steps(buf.ctypes.data):
        raise RuntimeError("codec_stamps: reading the step stamps failed")
    b = buf.astype(np.int64) - t0
    n = int(((buf > 0) & (b >= 0)).sum()) // 2  # this launch's steps (earlier ones are older)
    return f"codec_stamps {what} steps: " + " ".join(
        f"{g}:{b[2 * g]}/{b[2 * g + 1]}" for g in range(n))


def alone(torch, timer, lib, call, blocks: int, names):
    """The median over 10 flushed calls (after 3) of each phase's earliest
    and latest block."""
    import statistics

    runs = []
    for _ in range(13):
        timer.flush_buf.zero_()
        call()
        runs.append(phases(torch, lib, blocks, names))
    return {k: (int(statistics.median(r[k][0] for r in runs[3:])),
                int(statistics.median(r[k][1] for r in runs[3:]))) for k in runs[0]}


def roundtrip(torch, cs, lib) -> int:
    """``--roundtrip``: the dispatch codec's roundtrip alone at 8 and 1024
    rows, then the last launch of serving decode steps on the codec model."""
    from repro_torch.kernels.lowrank import ops as lr
    from repro_torch.models.model import Model
    from repro_torch.serving import ServingEngine

    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.linalg.qr(torch.randn(768, 384, generator=g, device="cuda"))[0]
    enc, dec = q.bfloat16().contiguous(), q.T.bfloat16().contiguous()
    lib.read_steps.argtypes = [ctypes.c_void_p]
    for T in (8, 1024):
        x = torch.randn(T, 768, generator=g, device="cuda").bfloat16()
        blocks = 6 * lr.roundtrip_split(T, 384, torch.bfloat16) * -(-T // 64)
        med = alone(torch, timer, lib, functools.partial(lr.lowrank_roundtrip_loss, x, enc, dec),
                    blocks, RT_PHASES)
        print(line(f"roundtrip alone T={T} (L2 flushed, median of 10)", med), flush=True)
        print(steps_line(torch, lib, f"roundtrip alone T={T}, last call", lib_stamps(lib)),
              flush=True)
    model = Model(cs.dispatch_config(), device="cuda")
    eng = ServingEngine(model, model.init(torch.Generator(device="cuda").manual_seed(0)),
                        max_batch=8, max_len=256, page_size=16, prefill_chunk=32)
    for r in cs.stream_requests(model.cfg.vocab_size, 8, 0, 12, hi=40):
        eng.submit(r)
    step = 0
    while eng.busy():
        eng.step()
        if step >= 4 and step % 2 == 0:  # a step's last launch: 8 rows of the last MoE layer
            print(line(f"roundtrip in serving decode, step {step}",
                       phases(torch, lib, 6 * lr.roundtrip_split(8, 384, torch.bfloat16),
                              RT_PHASES)), flush=True)
            print(steps_line(torch, lib, f"roundtrip in serving decode, step {step}",
                             lib_stamps(lib)), flush=True)
        step += 1
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("codec_stamps: no CUDA device", file=sys.stderr)
        return 2
    rt = "--roundtrip" in sys.argv[1:]
    stamped_package(RT_EDITS if rt else EDITS)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import PROFILES
    from repro_torch.kernels.lowrank import ops as lr
    from repro_torch.models.model import Model

    lib = lr._lib()
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    print(cs.nvidia_smi(), flush=True)
    if rt:
        return roundtrip(torch, cs, lib)
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    enc = torch.linalg.qr(torch.randn(768, 384, generator=g, device="cuda"))[0]
    enc = enc.bfloat16().contiguous()
    for T in (4, 32, 128):
        x = torch.randn(T, 768, generator=g, device="cuda").bfloat16()
        med = alone(torch, timer, lib, functools.partial(lr.lowrank_encode_quant, x, enc),
                    6 * -(-T // 64), PHASES)
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
