"""Lane-death migration over int8 KV pages, the port against the reference
(``test_torch_chaos.py``'s harness: smoke tinyllama at 4 layers in f32
activations on the CPU, ``timing="modeled"`` on a ``VirtualClock``, three
lanes at splits 1, 2 and 3): lane 0 dies mid-decode while both other
lanes hold pages of the shared cloud storage; the migrated int8 codes and
f16 scales restore exactly on a survivor at another split (tokens equal
the quantized run without the crash), and the metered spill is the stored
size, below 0.7 of the f32 pools' run."""

import torch

from test_torch_chaos import (  # noqa: F401
    assert_runs_equal,
    both,
    crash_when_loaded,
    prompts_requests,
    run,
    tiny_pair,
)

torch.set_num_threads(1)


def test_quantized_migration_at_the_stored_size(tiny_pair):
    """int8 KV: the migrated codes and scales restore exactly (tokens equal
    the quantized run without the crash) and the metered spill is the
    stored size, below 0.7 of the f32 run's."""
    kw = dict(n_lanes=3, max_len=64, force_splits=[1, 2, 3], requests=prompts_requests)
    j, t = both(tiny_pair, hook=crash_when_loaded(0), quantize_kv=True, **kw)
    assert_runs_equal(j, t)
    clean = run("torch", tiny_pair, quantize_kv=True, **kw)
    assert clean.tokens == t.tokens
    dense = run("torch", tiny_pair, hook=crash_when_loaded(0), **kw)
    mq, md = t.fleet.metrics(), dense.fleet.metrics()
    assert mq["migrations"] == md["migrations"] >= 1
    assert 0 < mq["migration_spill_bytes"] < 0.7 * md["migration_spill_bytes"]
