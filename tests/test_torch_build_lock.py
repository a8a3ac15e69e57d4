"""``kernels.build``'s lock: processes started together on a fresh tree
(the ranks of a mesh) build a library once.  A stub ``nvcc`` (a script
that counts its runs, sleeps, then writes the output file) stands in for
the compiler, which this machine does not have."""

import subprocess
import sys
import textwrap
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

STUB = """#!{python}
import os, sys, time
with open({count!r}, "a") as f:
    f.write("run\\n")
time.sleep(0.5)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").write(b"stub library")
"""

RANK = """
import sys
sys.path.insert(0, {src!r})
from pathlib import Path
from repro_torch.kernels import build
build.BUILD_DIR = Path({build_dir!r})
build._nvcc = lambda: {stub!r}
print(build.build(["lowrank", "quant"])["lowrank"])
"""


def _race(tmp_path, n=4):
    count, stub, build_dir = tmp_path / "runs", tmp_path / "nvcc", tmp_path / "kernels"
    stub.write_text(STUB.format(python=sys.executable, count=str(count)))
    stub.chmod(0o755)
    code = textwrap.dedent(RANK.format(src=str(SRC), build_dir=str(build_dir), stub=str(stub)))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(n)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    return [o[0].strip() for o in outs], count.read_text().count("run"), build_dir


def test_ranks_on_a_fresh_tree_build_each_library_once(tmp_path):
    paths, runs, build_dir = _race(tmp_path)
    assert runs == 2  # one nvcc for each source, not one for each process
    assert len(set(paths)) == 1 and Path(paths[0]).read_bytes() == b"stub library"
    assert not list(build_dir.glob("*.tmp"))
    assert (build_dir / "lock").exists()  # left behind, harmless
    # a second start finds the libraries and runs no compiler
    _, runs_after, _ = _race(tmp_path, n=2)
    assert runs_after == 2
