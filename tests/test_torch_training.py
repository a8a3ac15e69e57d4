"""The port's training pieces against the reference's, on the CPU: the
optimizers (the reference's quadratic, factored-state and clip cases, and
the schedule), ``cross_entropy_loss``, the data pipeline's batches, the
checkpointer (and checkpoints crossing between the packages both ways),
``StepGuard`` / ``FailureInjector`` / ``StragglerMitigator``, and the
``Trainer`` (failure recovery and resume) with its log of losses against
the reference trainer's from the same bridged params.

Tolerances: optimizer values 1e-6 relative after a few steps (the same
f32 formulas, the reference's scalars computed in f32 here too; the
schedule's cosine may differ by an ulp), 1e-5 (atol 1e-6) over the
quadratic's 50 steps, whose roundings accumulate; losses 1e-5 relative
(f32 forward and backward, sums in another order).
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.data import pipeline as jpipeline
from repro.distributed.fault import FailureInjector as JFailureInjector
from repro.models.layers import cross_entropy_loss as jcross_entropy_loss
from repro.training import optimizer as jopt
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import pipeline
from repro_torch.distributed.fault import FailureInjector, StepGuard, StragglerMitigator
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.trainer import Trainer, TrainerConfig

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_on_the_quadratic_equals_the_reference(name):
    """The reference's quadratic (``tests/test_checkpoint_training.py``):
    50 steps from the same start, the params equal the reference's after
    every step, and the loss falls below 5% of its start."""
    start = np.asarray([3.0, -2.0, 1.5], np.float32).reshape(1, 3) * np.ones((8, 3), np.float32)
    kw = dict(name=name, lr=0.1, warmup_steps=1, decay_steps=200, weight_decay=0.0)
    jp = {"w": jnp.asarray(start)}
    jstate = jopt.init_optimizer(name, jp)
    jcfg = jopt.OptimizerConfig(**kw)
    tp = {"w": torch.from_numpy(start.copy())}
    tstate = opt_mod.init_optimizer(name, tp)
    tcfg = opt_mod.OptimizerConfig(**kw)
    step = jax.jit(lambda g, s, p: jopt.apply_optimizer(name, jcfg, g, s, p))
    for i in range(50):
        jp, jstate, jlr = step({"w": 2 * jp["w"]}, jstate, jp)
        tp, tstate, tlr = opt_mod.apply_optimizer(name, tcfg, {"w": 2 * tp["w"]}, tstate, tp)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-6)
        assert abs(float(tlr) - float(jlr)) <= 1e-6 * float(jlr)
    assert int(tstate["step"]) == int(jstate["step"]) == 50
    assert float((tp["w"] ** 2).sum()) < 0.05 * float((start ** 2).sum())


def test_adafactor_state_is_factored_and_equals_the_reference():
    """Factored second moments for leaves of >= 2 dims at least 8 x 8 (row
    and column statistics), a full one otherwise; after a step with weight
    decay every statistic and param equals the reference's."""
    rng = np.random.default_rng(0)
    arrs = {"w": rng.standard_normal((32, 16)).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32),
            "t": rng.standard_normal((4, 8, 8)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in arrs.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    st = opt_mod.init_optimizer("adafactor", tp)
    assert set(st["stats"]["w"]) == {"vr", "vc"} and set(st["stats"]["b"]) == {"v"}
    assert st["stats"]["w"]["vr"].shape == (32,) and st["stats"]["w"]["vc"].shape == (16,)
    assert st["stats"]["t"]["vr"].shape == (4, 8) and st["stats"]["t"]["vc"].shape == (4, 8)
    cfg = dict(name="adafactor", lr=0.01, warmup_steps=1)
    jp = {k: jnp.asarray(v) for k, v in arrs.items()}
    js = jopt.init_optimizer("adafactor", jp)
    for _ in range(2):
        jp, js, _ = jopt.apply_optimizer("adafactor", jopt.OptimizerConfig(**cfg), grads, js, jp)
        tp, st, _ = opt_mod.apply_optimizer("adafactor", opt_mod.OptimizerConfig(**cfg),
                                            {k: torch.from_numpy(v) for k, v in grads.items()},
                                            st, tp)
    for k in arrs:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        for s in st["stats"][k]:
            np.testing.assert_allclose(st["stats"][k][s].numpy(), np.asarray(js["stats"][k][s]),
                                       rtol=1e-6)


def test_adamw_decays_matrices_only_and_equals_the_reference():
    rng = np.random.default_rng(1)
    arrs = {"m": rng.standard_normal((6, 5)).astype(np.float32),
            "v": rng.standard_normal(5).astype(np.float32)}
    grads = {k: rng.standard_normal(a.shape).astype(np.float32) for k, a in arrs.items()}
    cfg = dict(lr=0.05, warmup_steps=2, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in arrs.items()}
    js = jopt.init_optimizer("adamw", jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    ts = opt_mod.init_optimizer("adamw", tp)
    for _ in range(3):
        jp, js, _ = jopt.apply_optimizer("adamw", jopt.OptimizerConfig(**cfg), grads, js, jp)
        tp, ts, _ = opt_mod.apply_optimizer("adamw", opt_mod.OptimizerConfig(**cfg),
                                            {k: torch.from_numpy(v) for k, v in grads.items()},
                                            ts, tp)
    for k in arrs:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]), rtol=1e-6)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]), rtol=1e-6)
    # without decay on the vector, its update is the same with and without it
    ts0 = opt_mod.init_optimizer("adamw", {"v": torch.from_numpy(arrs["v"].copy())})
    p0 = {"v": torch.from_numpy(arrs["v"].copy())}
    opt_mod.apply_optimizer("adamw", opt_mod.OptimizerConfig(lr=0.05, warmup_steps=2,
                                                             weight_decay=0.0),
                            {"v": torch.from_numpy(grads["v"])}, ts0, p0)
    ts1 = opt_mod.init_optimizer("adamw", {"v": torch.from_numpy(arrs["v"].copy())})
    p1 = {"v": torch.from_numpy(arrs["v"].copy())}
    opt_mod.apply_optimizer("adamw", opt_mod.OptimizerConfig(**cfg),
                            {"v": torch.from_numpy(grads["v"])}, ts1, p1)
    assert torch.equal(p0["v"], p1["v"])


def test_grad_clip_and_schedule_equal_the_reference():
    g = [torch.ones(4) * 10.0, torch.full((2, 3), -3.0)]
    clipped, norm = opt_mod.clip_by_global_norm(g, 1.0)
    jclipped, jnorm = jopt.clip_by_global_norm({"a": jnp.ones(4) * 10.0,
                                                "b": jnp.full((2, 3), -3.0)}, 1.0)
    assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
    np.testing.assert_allclose(clipped[0].numpy(), np.asarray(jclipped["a"]), rtol=1e-6)
    np.testing.assert_allclose(clipped[1].numpy(), np.asarray(jclipped["b"]), rtol=1e-6)
    assert abs(float(opt_mod.global_norm(clipped)) - 1.0) < 1e-5
    small, n = opt_mod.clip_by_global_norm([torch.full((3,), 0.1)], 1.0)
    assert torch.equal(small[0], torch.full((3,), 0.1)) and float(n) < 1.0
    cfg = dict(lr=3e-4, warmup_steps=100, decay_steps=1000, min_lr_ratio=0.1)
    for step in (0, 1, 50, 100, 101, 500, 999, 1000, 5000):
        want = float(jopt.lr_schedule(jopt.OptimizerConfig(**cfg), jnp.asarray(step)))
        got = float(opt_mod.lr_schedule(opt_mod.OptimizerConfig(**cfg), step))
        assert abs(got - want) <= 1e-7 * max(want, 1e-12), (step, got, want)


def test_cross_entropy_with_masked_labels_equals_the_reference():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 5] = -7
    for z in (1e-4, 0.0):
        want_loss, want = jcross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z)
        got_loss, got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), z)
        assert abs(float(got_loss) - float(want_loss)) <= 1e-6 * float(want_loss)
        for k in ("ce_loss", "z_loss", "tokens"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-6 * max(float(want[k]), 1e-12)
    assert float(got["tokens"]) == 17.0
    none, m = cross_entropy_loss(torch.from_numpy(logits), torch.full((3, 7), -1))
    assert float(none) == 0.0 and float(m["tokens"]) == 1.0  # the denominator's floor
    # a bf16 input is reduced in f32
    bf, _ = cross_entropy_loss(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert bf.dtype == torch.float32


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("task", ["lm", "glue_proxy", "squad_proxy"])
def test_batches_equal_the_reference(task):
    cfg = dict(task=task, vocab_size=300, seq_len=24, seed=3)
    want = list(jpipeline.batches(jpipeline.DataConfig(**cfg), 4, 3, seed=11))
    got = list(pipeline.batches(pipeline.DataConfig(**cfg), 4, 3, seed=11))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    logits = np.random.default_rng(0).standard_normal((4, 24, 300))
    assert pipeline.eval_accuracy(logits, want[0]["labels"]) == jpipeline.eval_accuracy(
        logits, want[0]["labels"])


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip_gc_tmp_async_and_shape_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path / "a"), keep=2)
    state = ({"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}},
             {"step": torch.tensor(3, dtype=torch.int32)})
    ck.save(7, state, {"note": "x"})
    template = ({"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}},
                {"step": torch.zeros((), dtype=torch.int32)})
    step, got = ck.restore(template)
    assert step == 7 and ck.metadata()["note"] == "x"
    assert torch.equal(got[0]["a"], state[0]["a"]) and torch.equal(got[0]["b"]["c"], torch.ones(4))
    assert got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 3
    for s in (8, 9, 10):
        ck.save(s, state)
    assert ck.all_steps() == [9, 10]  # keep=2
    os.makedirs(tmp_path / "a" / "step_00000099.tmp")  # a crashed write
    assert ck.latest_step() == 10
    # async: the host copy is taken at the call, so an update right after
    # does not reach the file
    x = torch.ones(3)
    ck.async_save(11, {"x": x})
    x.add_(5.0)
    ck.wait()
    assert ck.latest_step() == 11
    assert torch.equal(ck.restore({"x": torch.zeros(3)})[1]["x"], torch.ones(3))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore({"x": torch.zeros(2, 2)})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore({"y": torch.zeros(3)})
    # a bf16 leaf is written as f32 and restored into its template's type
    ck.save(12, {"x": torch.full((3,), 1.5, dtype=torch.bfloat16)})
    got = ck.restore({"x": torch.zeros(3, dtype=torch.bfloat16)})[1]["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, torch.full((3,), 1.5,
                                                                        dtype=torch.bfloat16))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The trainer's state ``(params, opt_state)`` of smoke llama4-scout
    (stacked blocks, a shared expert, Adafactor's stats) written by the
    port restores in the reference's ``Checkpointer`` and the other way
    round, every leaf equal."""
    jcfg = jsmoke(jget("llama4-scout-17b-16e"))
    from repro.models.model import build_model

    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0)))
    jstate = jax.tree.map(np.asarray, jopt.init_optimizer("adafactor", jp))
    jstate["stats"] = jax.tree.map(lambda v: v + 0.25, jstate["stats"])
    tp = params_from_numpy(jp, "cpu")
    tstate = opt_mod.init_optimizer("adafactor", tp)
    tstate["stats"] = opt_mod.tree_map(lambda v: v + 0.25, tstate["stats"])
    tstate["step"] = torch.tensor(5, dtype=torch.int32)
    jstate["step"] = np.asarray(5, np.int32)

    Checkpointer(str(tmp_path / "port")).save(5, (tp, tstate))
    step, (rp, rs) = JCheckpointer(str(tmp_path / "port")).restore((jp, jstate))
    assert step == 5
    for a, b in zip(jax.tree.leaves((rp, rs)), jax.tree.leaves((jp, jstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    JCheckpointer(str(tmp_path / "ref")).save(5, (jp, jstate))
    zeros = opt_mod.tree_map(torch.zeros_like, tp)
    zstate = opt_mod.init_optimizer("adafactor", zeros)
    step, (gp, gs) = Checkpointer(str(tmp_path / "ref")).restore((zeros, zstate))
    assert step == 5 and int(gs["step"]) == 5
    for a, b in zip(opt_mod.tree_leaves(gp) + opt_mod.tree_leaves(gs["stats"]),
                    opt_mod.tree_leaves(tp) + opt_mod.tree_leaves(tstate["stats"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- fault pieces


def test_step_guard_injector_and_straggler():
    g = StepGuard(consecutive_bad_limit=2)
    assert g.check(1.0)
    assert not g.check(float("nan"))
    assert not g.check(float("inf"))
    with pytest.raises(RuntimeError):
        g.check(float("nan"))
    g = StepGuard(max_grad_norm=10.0)
    assert not g.check(1.0, 11.0) and g.check(1.0, 9.0) and g.bad_count == 0
    inj = FailureInjector(fail_steps=(2,))
    assert inj.maybe_fail(1, 0.5) == 0.5
    assert np.isnan(inj.maybe_fail(2, 0.5))
    assert inj.maybe_fail(2, 0.5) == 0.5  # one-shot
    with pytest.raises(RuntimeError, match="injected"):
        FailureInjector(fail_steps=(0,), kind="exception").maybe_fail(0, 1.0)
    s = StragglerMitigator(window=10, threshold=2.0)
    for i in range(8):
        assert s.record(i, 0.1) is None
    assert s.record(8, 0.5) == "reshard_recommended"
    assert s.flagged == [8]


# ---------------------------------------------------------------- the trainer


def _cfgs():
    name = "tinyllama-1.1b"
    return (jsmoke(jget(name)).replace(num_layers=1, dtype="float32"),
            smoke_config(get_config(name)).replace(num_layers=1, dtype="float32"))


def _data(mod, seq=32, batch=8):
    return itertools.cycle(mod.batches(mod.DataConfig(task="lm", vocab_size=512, seq_len=seq),
                                       batch, 40))


def _trainers(tmp_path, tag, total, injector=None, jinjector=None, bridge=True):
    """The reference trainer and the port's on the same config, data and
    checkpoint settings; the port's params and optimizer state bridged
    from the reference's after ``initialize()`` (unless it resumed)."""
    jcfg, cfg = _cfgs()
    kw = dict(total_steps=total, checkpoint_every=4, log_every=1, async_checkpoint=False)
    jt = JTrainer(jcfg, _data(jpipeline), failure_injector=jinjector,
                  trainer_cfg=JTrainerConfig(checkpoint_dir=str(tmp_path / f"ref{tag}"), **kw)
                  ).initialize()
    tt = Trainer(cfg, _data(pipeline), failure_injector=injector, device="cpu",
                 trainer_cfg=TrainerConfig(checkpoint_dir=str(tmp_path / f"port{tag}"), **kw)
                 ).initialize()
    if bridge:
        tt.params = params_from_numpy(jax.tree.map(np.asarray, jt.params), "cpu")
        tt.opt_state = params_from_numpy(jax.tree.map(np.asarray, jt.opt_state), "cpu")
    return jt, tt


def _logs_equal(got, want):
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * abs(b["grad_norm"]), (a, b)


def test_trainer_failure_recovery_equals_the_reference(tmp_path):
    """A NaN injected at step 6 (checkpoints every 4): one restore to step
    4, 12 steps in all, and every logged loss equals the reference
    trainer's."""
    jt, tt = _trainers(tmp_path, "", 12, FailureInjector(fail_steps=(6,)),
                       JFailureInjector(fail_steps=(6,)))
    want, got = jt.run(), tt.run()
    assert got["final_step"] == want["final_step"] == 12
    assert got["restores"] == want["restores"] == 1
    # steps 5 and 6 are logged twice: before the failure and after the restore
    assert [m["step"] for m in got["log"]] == list(range(1, 7)) + list(range(5, 13))
    assert all(np.isfinite(m["loss"]) for m in got["log"])
    _logs_equal(got["log"], want["log"])
    assert Checkpointer(str(tmp_path / "port")).metadata()["final"] is True


def test_trainer_resume_equals_the_reference(tmp_path):
    """A run of 6 steps (checkpoints every 4, and the final one at 6), then
    a trainer that resumes from the latest checkpoint (step 6, not a
    restart) and runs to 9: each run's losses equal the reference's."""
    jt, tt = _trainers(tmp_path, "", 6)
    _logs_equal(tt.run()["log"], jt.run()["log"])
    jt2, tt2 = _trainers(tmp_path, "", 9, bridge=False)
    assert tt2.step == jt2.step == 6  # resumed, not restarted
    want, got = jt2.run(), tt2.run()
    assert got["final_step"] == want["final_step"] == 9
    _logs_equal(got["log"], want["log"])
