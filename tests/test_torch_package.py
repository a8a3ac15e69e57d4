"""Package-level checks of the port: it imports neither JAX nor the
reference package, its config copies equal the reference's field by field,
the numpy bridge carries the reference's params over one to one, its own
init matches their shapes, and ``chip_smoke.py`` refuses to run without a
CUDA device."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models.model import build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import transformer
from repro_torch.models.model import leaves

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _modules():
    out = []
    for p in (SRC / "repro_torch").rglob("*.py"):
        parts = p.relative_to(SRC).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(out)


def test_port_imports_neither_jax_nor_the_reference():
    mods = _modules()
    assert {"repro_torch.serving.engine", "repro_torch.serving.stream",
            "repro_torch.core.expertpool", "repro_torch.bridge",
            "repro_torch.kernels.quant", "repro_torch.kernels.quant.ops",
            "repro_torch.distributed.topology", "repro_torch.distributed.collectives",
            "repro_torch.launch.mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'triton')\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}


def test_chip_smoke_fails_without_a_card(tmp_path):
    """With no CUDA device the script exits non-zero and prints no result,
    from the repository and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    for where, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, timeout=120, cwd=where)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_config_copies_equal_the_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget(name))
    assert dataclasses.asdict(smoke_config(get_config(name))) == dataclasses.asdict(
        jsmoke(jget(name)))
    cfg, jcfg = get_config(name), jget(name)
    assert (cfg.head_dim, cfg.block_repeat, cfg.padded_vocab_size) == (
        jcfg.head_dim, jcfg.block_repeat, jcfg.padded_vocab_size)


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e", "tinyllama-1.1b",
                                  "qwen2-vl-2b", "mamba2-130m", "jamba-1.5-large-398b",
                                  "whisper-base"])
def test_bridge_and_init_match_the_reference_tree(name):
    # 4 layers, or one block of a longer pattern (jamba's 8)
    layers = max(4, len(jget(name).layer_pattern))
    jcfg = jsmoke(jget(name)).replace(num_layers=layers)
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu")
    own = transformer.init_params(smoke_config(get_config(name)).replace(num_layers=layers),
                                  torch.Generator().manual_seed(0))
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got, mine = tp, own
        for key in path:
            got, mine = got[key.key], mine[key.key]
        np.testing.assert_array_equal(got.numpy(), want)
        assert tuple(mine.shape) == want.shape and mine.dtype == got.dtype
    n_leaves = len(jax.tree_util.tree_leaves(jp))
    assert len(list(leaves(tp))) == n_leaves == len(list(leaves(own)))


def test_compute_params_casts_only_what_every_use_casts():
    cfg = smoke_config(get_config("llama4-scout-17b-16e"))
    p = transformer.compute_params(
        transformer.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    blk = p["blocks"]["pos0"]
    assert p["embed"].dtype == p["lm_head"].dtype == torch.bfloat16
    assert blk["attn"]["wq"].dtype == blk["moe"]["wi"].dtype == blk["moe"]["shared"]["wg"].dtype == torch.bfloat16
    assert blk["norm1"].dtype == p["final_norm"].dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in blk["moe"]["gate"].values())
    # the SSM's projections are cast; its conv weights (read in f32 by the
    # decode step), A_log, D, dt_bias and norm stay f32 (jamba: SSM, MoE
    # and attention in one pattern)
    cfg = smoke_config(get_config("jamba-1.5-large-398b"))
    p = transformer.compute_params(
        transformer.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    ssm = p["blocks"]["pos0"]["ssm"]
    assert {k for k, v in ssm.items() if v.dtype == torch.bfloat16} == {
        "w_z", "w_x", "w_bc", "w_dt", "out_proj"}
    assert {k for k, v in ssm.items() if v.dtype == torch.float32} == {
        "conv_x", "conv_x_b", "conv_bc", "conv_bc_b", "A_log", "D", "dt_bias", "norm_w"}
    assert p["blocks"]["pos4"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["blocks"]["pos1"]["moe"]["wi"].dtype == torch.bfloat16
