"""The port's expert-parallel MoE bodies against the reference's on the same
mesh: ``apply_moe`` on a port topology of 4 gloo ranks (CPU) against the
reference's ``apply_moe`` under ``shard_map`` on 4 host devices, the a2a
and tp bodies at meshes (1,4) and (2,2), the dispatch codec off and at rank
64, a capacity factor of 8 (nothing drops) and of 1 (assignments drop:
which ones follows the order of the bucket ranks), the decode
degeneracies (a2a falling back to tp when ``ep`` does not divide the
data-local count; a count that ``dp`` does not divide staying replicated),
serving's ``eval_capacity_factor`` and an expert mask.

The reference runs in one subprocess (its device count is fixed when JAX
starts), its calls jitted; it draws the params and hands them, with the
outputs, to the port through an ``.npz``.  The port runs every case in
one ``spawn_ranks`` of 4 ranks (``_torch_ep_ranks.py``: the ranks import no
JAX), which also holds the collectives to their definitions.

Tolerances: ``y`` within 2e-4 (the reference's own EP tolerance,
``tests/test_distributed.py``), the aux (router losses, routing statistics,
``dropped_frac``) within 1e-6; the ranks' outputs are equal.
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
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import moe as tmoe
from repro_torch.distributed.topology import Topology, single_device_topology
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TESTS = os.path.dirname(__file__)

_C = dict(cf=8.0, codec=False, B=4, S=16, train=True, mask=False)
# name -> (impl asked for, mesh, the body that must run, overrides)
CASES = {
    "a2a (1,4)": ("a2a", (1, 4), "a2a", {}),
    "tp (1,4)": ("tp", (1, 4), "tp", {}),
    "a2a (2,2)": ("a2a", (2, 2), "a2a", {}),
    "tp (2,2)": ("tp", (2, 2), "tp", {}),
    "auto (1,4)": ("auto", (1, 4), "a2a", {}),
    "a2a (1,4) codec": ("a2a", (1, 4), "a2a", dict(codec=True)),
    "tp (1,4) codec": ("tp", (1, 4), "tp", dict(codec=True)),
    "a2a (2,2) codec": ("a2a", (2, 2), "a2a", dict(codec=True)),
    "tp (2,2) codec": ("tp", (2, 2), "tp", dict(codec=True)),
    "a2a (1,4) drops": ("a2a", (1, 4), "a2a", dict(cf=1.0)),
    "tp (1,4) drops": ("tp", (1, 4), "tp", dict(cf=1.0)),
    "a2a (2,2) drops": ("a2a", (2, 2), "a2a", dict(cf=1.0)),
    "tp (2,2) drops": ("tp", (2, 2), "tp", dict(cf=1.0)),
    "a2a (1,4) drops codec": ("a2a", (1, 4), "a2a", dict(cf=1.0, codec=True)),
    # 6 tokens: t_loc 6 (1,4) / 3 (2,2), which ep does not divide
    "a2a->tp (1,4) T=6": ("a2a", (1, 4), "tp", dict(B=6, S=1)),
    "a2a->tp (2,2) T=6": ("a2a", (2, 2), "tp", dict(B=6, S=1)),
    # 3 tokens: dp 2 does not divide them, so they stay replicated
    "replicated (2,2) T=3": ("a2a", (2, 2), "tp", dict(B=3, S=1)),
    "replicated (2,2) T=5 codec": ("a2a", (2, 2), "tp", dict(B=5, S=1, codec=True)),
    # serving: eval_capacity_factor (1.0), no aux
    "a2a (1,4) serve": ("a2a", (1, 4), "a2a", dict(train=False)),
    "tp (2,2) serve codec": ("tp", (2, 2), "tp", dict(train=False, codec=True)),
    "a2a (1,4) mask": ("a2a", (1, 4), "a2a", dict(mask=True)),
}


def _cases():
    out = []
    for name, (impl, mesh, _, kw) in CASES.items():
        out.append({**_C, **kw, "name": name, "impl": impl, "mesh": list(mesh)})
    return out


REFERENCE = """
import json, os, dataclasses
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import sys; sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.configs import get_config, smoke_config
from repro.configs.base import CompressionConfig
from repro.core import moe
from repro.distributed.topology import Topology
from _torch_ep_ranks import NAME, CODEC_RANK, flatten

cases = json.load(open({cases!r}))
data = dict(np.load({inputs!r}))
base = smoke_config(get_config(NAME))
params = {{c: moe.init_moe(jax.random.PRNGKey(3), base.replace(compression=(
    CompressionConfig(rank=CODEC_RANK, boundaries=("dispatch",)) if c else None)))
    for c in (0, 1)}}
out = {{}}
for c in (0, 1):
    out.update(flatten(jax.tree.map(np.asarray, params[c]), f"params_{{c}}/"))
meshes = {{}}
for case in cases:
    mesh_shape = tuple(case["mesh"])
    if mesh_shape not in meshes:
        meshes[mesh_shape] = jax.make_mesh(mesh_shape, ("data", "model"),
                                           axis_types=(jax.sharding.AxisType.Auto,) * 2)
    mesh = meshes[mesh_shape]
    topo = Topology(mesh=mesh, data_axes=("data",), model_axis="model")
    cfg = base.replace(
        moe_impl=case["impl"],
        moe=dataclasses.replace(base.moe, capacity_factor=case["cf"]),
        compression=(CompressionConfig(rank=CODEC_RANK, boundaries=("dispatch",))
                     if case["codec"] else None))
    x = data["x_" + case["name"]]
    mask = data.get("mask_" + case["name"])
    with jax.set_mesh(mesh):
        spec = P("data", None, None) if x.shape[0] % mesh_shape[0] == 0 else P()
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
        fn = jax.jit(lambda p, xx, mm: moe.apply_moe(p, xx, cfg, topo, expert_mask=mm,
                                                      train=case["train"]))
        y, aux = fn(params[int(case["codec"])], xs,
                    None if mask is None else jnp.asarray(mask))
    out["x_" + case["name"]] = x
    if mask is not None:
        out["mask_" + case["name"]] = mask
    out["y_" + case["name"]] = np.asarray(y)
    for k, v in aux.items():
        out["aux_" + case["name"] + "/" + k] = np.asarray(v)
np.savez({out!r}, **out)
print("REF OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, the port's per-rank results)."""
    tmp = tmp_path_factory.mktemp("ep")
    cases = _cases()
    rng = np.random.default_rng(0)
    d = smoke_config(get_config(ranks.NAME)).d_model
    inputs = {}
    for case in cases:
        inputs["x_" + case["name"]] = rng.standard_normal(
            (case["B"], case["S"], d)).astype(np.float32)
        if case["mask"]:
            inputs["mask_" + case["name"]] = np.asarray([1, 1, 0, 1, 1, 0, 1, 1], bool)
    paths = {k: str(tmp / f"{k}") for k in ("cases.json", "inputs.npz", "ref.npz")}
    json.dump(cases, open(paths["cases.json"], "w"))
    np.savez(paths["inputs.npz"], **inputs)
    code = REFERENCE.format(src=SRC, tests=TESTS, cases=paths["cases.json"],
                            inputs=paths["inputs.npz"], out=paths["ref.npz"])
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "REF OK" in proc.stdout, proc.stderr[-4000:]
    ref = dict(np.load(paths["ref.npz"]))
    port = tmesh.spawn_ranks((1, 4), ranks.ep_module, paths["ref.npz"], cases, policy="tp",
                             device="cpu", timeout_s=240)
    return ref, port


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_equals_the_reference_on_the_same_mesh(runs, name):
    ref, port = runs
    _, _, body, kw = CASES[name]
    y0, aux0, bodies = port[0]["moe"][name]
    for r in range(1, 4):  # every rank holds the whole output and the same aux
        y, aux, _ = port[r]["moe"][name]
        np.testing.assert_array_equal(y, y0)
        assert set(aux) == set(aux0)
        for k in aux:
            np.testing.assert_array_equal(aux[k], aux0[k])
    assert bodies == ((1, 0) if body == "a2a" else (0, 1)), (name, bodies)
    np.testing.assert_allclose(y0, ref["y_" + name], rtol=0, atol=2e-4)
    want = {k.split("/", 1)[1]: v for k, v in ref.items() if k.startswith(f"aux_{name}/")}
    if not kw.get("train", True):
        assert aux0 == {}  # serving skips the router's aux
        return
    assert set(aux0) == set(want), (sorted(aux0), sorted(want))
    for k, v in want.items():
        np.testing.assert_allclose(aux0[k], v, rtol=1e-6, atol=1e-6, err_msg=f"{name} {k}")
    if "drops" in name:
        assert float(want["dropped_frac"]) > 0.0  # the drop path really ran
    else:
        assert float(want["dropped_frac"]) == 0.0


def test_collectives_on_gloo_ranks(runs):
    """Tiled all_to_all / all_gather, psum (f32 inside, the input's type
    out) and pmean over 4 ranks, and the counters (calls and bytes handed
    in, none of them in a backward)."""
    _, port = runs
    n = 4
    for r in range(n):
        (a2a, ag, ps, pm), counts, ps_dtype, where = port[r]["coll"]
        xs = [np.arange(2 * n, dtype=np.float32) + 100 * j for j in range(n)]
        np.testing.assert_array_equal(a2a, np.concatenate([x[2 * r : 2 * r + 2] for x in xs]))
        np.testing.assert_array_equal(ag, np.concatenate([x[:2] for x in xs]))
        bf = [torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in xs]
        np.testing.assert_array_equal(
            ps, torch.from_numpy(np.sum(bf, axis=0)).to(torch.bfloat16).float().numpy())
        np.testing.assert_allclose(pm, np.mean(xs, axis=0), rtol=1e-6)
        assert ps_dtype == "torch.bfloat16" and where == "cpu"
        fwd = {k: {"calls": v["calls"], "bytes": v["bytes"]} for k, v in counts.items()}
        assert fwd == {"all_to_all": {"calls": 1, "bytes": 4 * 2 * n},
                       "all_gather": {"calls": 1, "bytes": 4 * 2},
                       "all_gather_rs": {"calls": 0, "bytes": 0},
                       "psum": {"calls": 1, "bytes": 2 * 2 * n},
                       "pmean": {"calls": 1, "bytes": 4 * 2 * n},
                       "pmax": {"calls": 0, "bytes": 0},
                       "reduce_scatter": {"calls": 0, "bytes": 0}}
        assert all(v["bwd_calls"] == v["bwd_bytes"] == 0 for v in counts.values())


def test_spawn_ranks_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="rank two fails"):
        tmesh.spawn_ranks((1, 4), ranks.fail_on_rank_two, device="cpu", timeout_s=60)


def test_topology_of_a_mesh():
    t = Topology(mesh_shape=(2, 4), coords=(1, 2))
    assert (t.dp_size, t.ep_size, t.tp_size, t.pp_size, t.num_devices) == (2, 4, 4, 1, 8)
    assert t.use_shard_map_moe and (t.model_index, t.data_index, t.rank) == (2, 1, 6)
    assert t.expert_slice(128) == slice(64, 96)
    one = single_device_topology()
    assert (one.ep_size, one.dp_size, one.num_devices, one.use_shard_map_moe) == (1, 1, 1, False)
    assert one.expert_slice(8) == slice(0, 8)
    dp_only = Topology(mesh_shape=(2, 4), coords=(0, 0), data_axes=("data", "model"),
                       model_axis=None)
    assert (dp_only.dp_size, dp_only.ep_size, dp_only.use_shard_map_moe) == (8, 1, False)


def test_topology_takes_a_pipeline_axis_and_the_heterogeneous_flag():
    """As the reference: both are declared and nothing reads them, so a
    pipeline axis's ranks are replicas (``pp_size`` its size) and the
    flag changes no size."""
    t = Topology(mesh_shape=(2, 2, 4), axis_names=("pipe", "data", "model"),
                 pipeline_axis="pipe", coords=(1, 1, 3), heterogeneous=True)
    assert (t.pp_size, t.dp_size, t.ep_size, t.num_devices) == (2, 2, 4, 16)
    assert (t.model_index, t.data_index, t.rank) == (3, 1, 15)
    assert Topology(mesh_shape=(1, 4), coords=(0, 0), heterogeneous=True).pp_size == 1


def test_what_waits_for_item_8c():
    """Sequence parallelism (ROADMAP item 8c): the flag builds a topology,
    and every policy sets the reference's fields (its
    ``make_topology``): ``seqp`` puts the experts and the sequence on the
    model axis with FSDP over the data axes, ``serve_seqp`` the same with
    weights resident, and under either a non-expert weight drops the model
    axis from its spec while the experts keep it."""
    t = Topology(mesh_shape=(1, 4), coords=(0, 2), seq_parallel_attn=True)
    assert (t.seq_parallel_attn, t.dp_size, t.ep_size, t.model_index) == (True, 1, 4, 2)
    want = {"tp": (("data",), "model", True, False),
            "serve_tp": (("data",), "model", False, False),
            "seqp": (("data",), "model", True, True),
            "serve_seqp": (("data",), "model", False, True),
            "dp": (("data", "model"), None, False, False),
            "fsdp": (("data", "model"), None, True, False)}
    assert set(want) == set(tmesh.POLICIES)
    for policy, fields in want.items():
        got = tmesh.policy_layout(policy)
        assert (got["data_axes"], got["model_axis"], got["fsdp"],
                got["seq_parallel_attn"]) == fields, policy
    pod = tmesh.policy_layout("seqp", ("pod", "data", "model"))
    assert pod["data_axes"] == ("pod", "data") and pod["seq_parallel_attn"]
    with pytest.raises(ValueError, match="model"):
        tmesh.policy_layout("serve_seqp", ("data",))
    with pytest.raises(ValueError, match="unknown"):
        tmesh.policy_layout("sp")
    from repro_torch.distributed.sharding import param_partition_spec

    for policy in ("seqp", "serve_seqp"):
        topo = Topology(mesh_shape=(2, 4), coords=(0, 0), **tmesh.policy_layout(policy))
        dp = "data" if policy == "seqp" else None
        assert param_partition_spec("blocks/pos0/attn/wq", (2, 128, 8, 32), topo) == (
            None, dp, None, None)
        assert param_partition_spec("blocks/pos0/moe/wi", (2, 8, 128, 64), topo) == (
            None, "model", dp, None)


def test_backend_rule():
    assert tmesh.backend_for(4, "cpu") == ("gloo", [torch.device("cpu")] * 4)
    with pytest.raises(ValueError):
        tmesh.backend_for(2, "tpu")
