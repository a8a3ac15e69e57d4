"""Synthetic data pipeline (port of the reference's ``data/pipeline.py``,
numpy only: for a seed it yields the reference's batches).

No GLUE or SQuAD offline; two proxy tasks have the *shape* of the paper's
datasets:

  * ``glue_proxy``  — sequence classification: the label token is the
    majority category of the sequence's content tokens; the model must
    emit it at the final position.  Tests gating quality: each category
    is generated by a different latent "task" (vocab permutation), so
    experts that specialize per-task win.

  * ``squad_proxy`` — associative recall (span extraction proxy): the
    context is key-value token pairs; the query names a key; the answer
    is that key's value.

  * ``lm`` — plain mixture-of-permutation-languages next-token prediction
    (used by the training example).

All generation is numpy, seeded, and cheap; ``batches`` yields dicts
matching the model's input contract ({"tokens", "labels"}), with labels
masked (-1) everywhere supervision doesn't apply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    task: str = "lm"  # lm | glue_proxy | squad_proxy
    vocab_size: int = 512
    seq_len: int = 64
    n_latent_tasks: int = 8  # latent mixture components (expert-aligned)
    n_classes: int = 4  # glue_proxy label count
    seed: int = 0


def _content_range(cfg: DataConfig) -> Tuple[int, int]:
    # reserve the low ids for special/label tokens
    lo = 2 + max(cfg.n_classes, cfg.n_latent_tasks)
    return lo, cfg.vocab_size


def make_dataset(cfg: DataConfig):
    """Returns sample(rng) -> (tokens [S], labels [S])."""
    rng0 = np.random.default_rng(cfg.seed)
    lo, hi = _content_range(cfg)
    perms = [
        rng0.permutation(np.arange(lo, hi)) for _ in range(cfg.n_latent_tasks)
    ]

    def sample_lm(rng) -> Tuple[np.ndarray, np.ndarray]:
        t = rng.integers(cfg.n_latent_tasks)
        perm = perms[t]
        toks = np.empty(cfg.seq_len, np.int32)
        toks[0] = 2 + t  # task id token
        toks[1] = rng.integers(lo, hi)
        for i in range(2, cfg.seq_len):
            toks[i] = perm[toks[i - 1] - lo]  # deterministic task dynamics
        labels = np.concatenate([toks[1:], [-1]]).astype(np.int32)
        labels[0] = -1  # first transition is random
        return toks, labels

    def sample_glue(rng) -> Tuple[np.ndarray, np.ndarray]:
        t = rng.integers(cfg.n_latent_tasks)
        cls = int(rng.integers(cfg.n_classes))
        n_cat = (hi - lo) // cfg.n_classes
        toks = np.empty(cfg.seq_len, np.int32)
        # content tokens: majority drawn from the label's category band,
        # passed through the latent task's permutation (distribution shift
        # per task => per-task experts help).
        for i in range(cfg.seq_len - 1):
            c = cls if rng.random() < 0.65 else int(rng.integers(cfg.n_classes))
            base = lo + c * n_cat + int(rng.integers(n_cat))
            toks[i] = perms[t][base - lo]
        toks[-1] = 0  # [CLS]-like position
        labels = np.full(cfg.seq_len, -1, np.int32)
        labels[-1] = 2 + cls  # label token id
        return toks, labels

    def sample_squad(rng) -> Tuple[np.ndarray, np.ndarray]:
        # Knowledge-retrieval proxy: each latent task t has its own global
        # key->value dictionary (perms[t]); the sequence interleaves queries
        # (keys) with their answers, supervised at answer positions.  The
        # model must memorize per-task dictionaries in its (expert)
        # parameters and condition on the task token — capacity- and
        # routing-sensitive, like closed-book QA.
        t = rng.integers(cfg.n_latent_tasks)
        perm = perms[t]
        toks = np.full(cfg.seq_len, 1, np.int32)
        labels = np.full(cfg.seq_len, -1, np.int32)
        toks[0] = 2 + t  # task token
        n_pairs = (cfg.seq_len - 1) // 2
        key_hi = lo + min(128, hi - lo)  # bounded fact set per task
        keys = rng.integers(lo, key_hi, n_pairs)
        for j in range(n_pairs):
            kpos = 1 + 2 * j
            toks[kpos] = keys[j]
            val = perm[keys[j] - lo]
            toks[kpos + 1] = val
            labels[kpos] = val  # predict the answer at the query position
        return toks, labels

    return {"lm": sample_lm, "glue_proxy": sample_glue, "squad_proxy": sample_squad}[
        cfg.task
    ]


def batches(
    cfg: DataConfig, batch_size: int, n_batches: int, seed: Optional[int] = None
) -> Iterator[Dict[str, np.ndarray]]:
    sampler = make_dataset(cfg)
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    for _ in range(n_batches):
        toks = np.empty((batch_size, cfg.seq_len), np.int32)
        labs = np.empty((batch_size, cfg.seq_len), np.int32)
        for b in range(batch_size):
            toks[b], labs[b] = sampler(rng)
        yield {"tokens": toks, "labels": labs}


def eval_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """Accuracy over supervised positions (labels >= 0)."""
    mask = labels >= 0
    pred = logits.argmax(-1)
    return float((pred[mask] == labels[mask]).mean())
