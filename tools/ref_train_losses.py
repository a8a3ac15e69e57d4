"""The reference's train step on full-width switch-base on the CPU: the
losses of ``--steps`` AdamW steps on ``chip_smoke.py`` phase 15's batches
(``data.pipeline``'s ``lm`` task at vocab 32128, 4 x 256, seed 0), for
comparing the port's training curve on the card with the reference's.

    PYTHONPATH=src python tools/ref_train_losses.py --lr 3e-4 --layers 12

Prints the step losses and the means of the first and last 5.  Full width
is heavy on a CPU: 4 layers take about 4 minutes, 12 about 12.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.data.pipeline import DataConfig, batches
from repro.launch.steps import make_train_step
from repro.models.model import build_model
from repro.training.optimizer import OptimizerConfig, init_optimizer


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()
    cfg = get_config("switch-base").replace(num_layers=args.layers, dtype=args.dtype)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    state = init_optimizer("adamw", params)
    step = jax.jit(make_train_step(model, OptimizerConfig(lr=args.lr, warmup_steps=5)))
    losses = []
    for b in batches(DataConfig(task="lm", vocab_size=cfg.vocab_size, seq_len=256, seed=0),
                     4, args.steps):
        params, state, metrics = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    print(f"switch-base {args.layers} layers {args.dtype} lr {args.lr:g}: "
          + " ".join(f"{x:.3f}" for x in losses))
    print(f"mean of the first 5 {np.mean(losses[:5]):.4f}, of the last 5 "
          f"{np.mean(losses[-5:]):.4f}")


if __name__ == "__main__":
    main()
