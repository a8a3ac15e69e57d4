"""The port's ``ServingEngine`` on an expert-parallel topology against the
reference's on the same mesh: 4 gloo ranks (CPU) on a (1,4) ``serve_tp``
topology against the reference's engine with ``Model(cfg, Topology(mesh of
(1,4) host devices, fsdp=False))``, f32, the same weights and requests;
the generated tokens must be equal.

Three runs: llama4-scout smoke with 4 slots (decode's 4 tokens split over
4 shards: a2a), qwen3-moe smoke (its rank-64 dispatch codec) with 4 slots
(a2a through the codec) and with 2 slots (2 decode tokens cannot be split
over 4 shards: the tp body, which puts the codec around the summed
partials, so its tokens are the reference's on the mesh, not a
single-device run's).  Prompts stream through 8-token chunks, which split
over 4 shards (a2a) in every run.  Serving takes ``eval_capacity_factor``
1.0, so a chunk's assignments can drop, and the port drops the
reference's.  Each rank's body counters show which body ran; the ranks'
tokens are equal (the engine checks it at the end of ``run``) and their
page pools drain.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_ep_ranks as ranks
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TESTS = os.path.dirname(__file__)
LAYERS = 2

RUNS = {
    "llama4-scout 4 slots": ("llama4-scout-17b-16e", 4),
    "qwen3-moe 4 slots": ("qwen3-moe-235b-a22b", 4),
    "qwen3-moe 2 slots": ("qwen3-moe-235b-a22b", 2),
}


def _runs():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, size=rng.integers(4, 20)).tolist() for _ in range(6)]
    return [dict(name=name, config=config, slots=slots, layers=LAYERS, prompts=prompts,
                 new=6, max_len=64, chunk=8) for name, (config, slots) in RUNS.items()]


REFERENCE = """
import json, os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import sys; sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np, jax
from repro.configs import get_config, smoke_config
from repro.distributed.topology import Topology
from repro.models.model import Model
from repro.serving.engine import Request, ServingEngine
from _torch_ep_ranks import flatten

runs = json.load(open({runs!r}))
mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
topo = Topology(mesh=mesh, data_axes=("data",), model_axis="model", fsdp=False)
out, tokens = {{}}, {{}}
for run in runs:
    cfg = smoke_config(get_config(run["config"])).replace(num_layers=run["layers"],
                                                          dtype="float32")
    model = Model(cfg, topo)
    params = model.init(jax.random.PRNGKey(0))
    out.update(flatten(jax.tree.map(np.asarray, params), "params_" + run["config"] + "/"))
    eng = ServingEngine(model, params, max_batch=run["slots"], max_len=run["max_len"],
                        prefill_chunk=run["chunk"])
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=run["new"])
            for i, p in enumerate(run["prompts"])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    tokens[run["name"]] = [[int(t) for t in r.generated] for r in reqs]
np.savez({params!r}, **out)
json.dump(tokens, open({tokens!r}, "w"))
print("REF OK")
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_serve")
    runs = _runs()
    paths = {k: str(tmp / k) for k in ("runs.json", "params.npz", "tokens.json")}
    json.dump(runs, open(paths["runs.json"], "w"))
    code = REFERENCE.format(src=SRC, tests=TESTS, runs=paths["runs.json"],
                            params=paths["params.npz"], tokens=paths["tokens.json"])
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "REF OK" in proc.stdout, proc.stderr[-4000:]
    want = json.load(open(paths["tokens.json"]))
    port = tmesh.spawn_ranks((1, 4), ranks.serve_runs, paths["params.npz"], runs,
                             policy="serve_tp", device="cpu", timeout_s=240)
    return want, port


@pytest.mark.parametrize("name", list(RUNS))
def test_engine_tokens_equal_the_reference_on_the_same_mesh(served, name):
    want, port = served
    slots = RUNS[name][1]
    for r in range(4):
        tokens, (a2a, tp), pages, calls = port[r][name]
        assert tokens == want[name], (r, name)
        assert pages == 0
        assert a2a > 0  # the prompt chunks (8 tokens over 4 shards)
        # decode: 4 tokens split over 4 shards (a2a), 2 do not (tp)
        assert (tp > 0) == (slots == 2), (name, a2a, tp)
        # serving runs no aux all-reduce; a2a: 3 exchanges and the gather
        assert calls["all_to_all"] == 3 * a2a and calls["pmean"] == 0
        assert calls["psum"] == tp and calls["all_gather"] == a2a, (name, calls)
