"""The port's VLM inputs (qwen2-vl-2b: M-RoPE and patch embeddings) against
the reference's, on the CPU in f32 on bridged weights.

``rope_angles`` with ``mrope_sections`` on positions that differ across the
(temporal, height, width) axes (1e-6), equal to plain RoPE when the three
axes agree, and refusing sections that do not cover ``head_dim // 2`` or
positions without the axis; ``embed_inputs`` with patch embeddings;
``Model.prefill`` with patch embeddings on a patch grid (logits and every
ring of the dense cache at 1e-4), then greedy ``decode_step`` s (equal
tokens); and ``decode_step_paged``, ``prefill_chunk_step`` and
``verify_chunk_step`` (logits at 1e-4).  Smoke qwen2-vl-2b at 4 layers:
head_dim 32, sections (4, 6, 6), 16 patches, 4 query heads on 2 kv heads.

With the same position on all three axes M-RoPE is plain RoPE, and every
engine feeds text positions that way; only a prefill whose patches sit on
a grid tests the sections, so ``test_grid_positions_move_the_logits``
checks that they do move the logits, in both packages alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.model import build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import Model

torch.set_num_threads(1)

NAME = "qwen2-vl-2b"
TOL = 1e-4  # f32, the same inputs through both packages
T_TEXT = 12  # text tokens after the patches


@pytest.fixture(scope="module")
def pair():
    """(reference model, params), (port model, the same params), f32."""
    jcfg = jsmoke(jget(NAME)).replace(num_layers=4, dtype="float32", param_dtype="float32")
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = smoke_config(get_config(NAME)).replace(num_layers=4, dtype="float32",
                                                 param_dtype="float32")
    return (jm, jp), (Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp),
                                                                  "cpu"))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


def grid_positions(B, P, T, side):
    """Qwen2-VL's layout of one image then text: the P patches on a
    1 x side x side grid (t = 0, h = i // side, w = i % side), the text
    continuing from ``side`` on all three axes; [B, 3, P + T] int32."""
    i = np.arange(P)
    img = np.stack([np.zeros(P, np.int64), i // side, i % side])
    txt = np.broadcast_to(side + np.arange(T), (3, T))
    return np.broadcast_to(np.concatenate([img, txt], axis=1), (B, 3, P + T)).astype(np.int32)


def vlm_batch(cfg, seed=0, B=2, T=T_TEXT):
    rng = np.random.default_rng(seed)
    P = cfg.vision_patches
    return {
        "tokens": rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32),
        "patch_embeds": rng.standard_normal((B, P, cfg.d_model)).astype(np.float32),
        "positions": grid_positions(B, P, T, int(np.sqrt(P))),
    }


# -- rope_angles ----------------------------------------------------------------


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_mrope_angles_match_reference(sections, hd):
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 4096, size=(2, 3, 40)).astype(np.int32)
    want = jattn.rope_angles(jnp.asarray(pos), hd, 1e6, sections)
    got = tattn.rope_angles(torch.from_numpy(pos), hd, 1e6, sections)
    assert got.shape == (2, 40, hd // 2) and got.dtype == torch.float32
    _close(got, want, 1e-6)
    # [B, 3, S] without sections: component 0, as in the reference
    _close(tattn.rope_angles(torch.from_numpy(pos), hd, 1e6),
           jattn.rope_angles(jnp.asarray(pos), hd, 1e6), 1e-6)


def test_uniform_positions_are_plain_rope():
    cfg = smoke_config(get_config(NAME))
    pos = torch.arange(20, dtype=torch.int32)[None].expand(2, 20)
    plain = tattn.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    three = pos[:, None].expand(2, 3, 20)
    assert torch.equal(
        tattn.rope_angles(three, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections), plain)
    assert torch.equal(tattn.model_angles(cfg, pos), plain)


def test_bad_sections_and_positions_raise():
    pos = torch.zeros(1, 3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="sum"):
        tattn.rope_angles(pos, 32, 1e4, (4, 6, 7))
    with pytest.raises(ValueError, match=r"\[B, 3, S\]"):
        tattn.rope_angles(pos[:, 0], 32, 1e4, (4, 6, 6))


# -- embeddings and the model -----------------------------------------------------


def test_embed_inputs_with_patches_match_reference(pair):
    (jm, jp), (tm, tp) = pair
    b = vlm_batch(tm.cfg)
    want = jtransformer.embed_inputs(jp, jm.cfg, jnp.asarray(b["tokens"]),
                                     jnp.asarray(b["patch_embeds"]))
    got = ttransformer.embed_inputs(tp, tm.cfg, torch.from_numpy(b["tokens"]),
                                    torch.from_numpy(b["patch_embeds"]))
    assert got.shape == (2, tm.cfg.vision_patches + T_TEXT, tm.cfg.d_model)
    _close(got, want, 0)


def test_prefill_with_patches_then_decode_match_reference(pair):
    """Patches on a 4 x 4 grid, then text: logits and every ring of the
    cache at 1e-4, ``lengths`` P + T; then 8 greedy ``decode_step`` s, whose
    positions are each slot's length on all three axes."""
    (jm, jp), (tm, tp) = pair
    b = vlm_batch(tm.cfg)
    S = tm.cfg.vision_patches + T_TEXT
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()}, max_len=S + 8)
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in b.items()}, max_len=S + 8)
    _close(tl, jl)
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist() == [S, S]
    for pos, entry in jc["blocks"].items():
        for n, leaf in entry.items():
            _close(tc["blocks"][pos][n], leaf)
    jt = tt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert torch.equal(tl.argmax(-1), torch.from_numpy(jt[:, 0]).long())
    got, want = [], []
    for _ in range(8):
        jl, jc = jm.decode_step(jp, jnp.asarray(jt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tt), tc)
        _close(tl, jl)
        jt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        tt = tl.argmax(-1).int()[:, None].numpy()
        want.append(jt[:, 0].tolist())
        got.append(tt[:, 0].tolist())
    assert got == want
    assert tc["lengths"].tolist() == [S + 8, S + 8]


def test_grid_positions_move_the_logits(pair):
    """The sections matter: the grid's logits differ from those of the same
    input at positions 0..S-1 on every axis, by the same amount in both
    packages."""
    (jm, jp), (tm, tp) = pair
    b = vlm_batch(tm.cfg, seed=1)
    flat = {k: v for k, v in b.items() if k != "positions"}
    tg, _ = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    tu, _ = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in flat.items()})
    jg, _ = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()})
    ju, _ = jm.prefill(jp, {k: jnp.asarray(v) for k, v in flat.items()})
    _close(tg, jg)
    _close(tu, ju)
    assert (tg - tu).abs().max().item() > 1e-2


def _pages(cfg, P, ps):
    return {f"pos{i}": {n: np.zeros((cfg.block_repeat, P + 1, ps, cfg.num_kv_heads,
                                     cfg.head_dim), np.float32) for n in ("k", "v")}
            for i in range(len(cfg.layer_pattern))}


def test_paged_steps_match_reference(pair):
    """A prompt chunk with a padding row, a decode step, then a verify chunk
    of C = 4 over paged pools: logits at 1e-4 (the verify's at every valid
    row)."""
    (jm, jp), (tm, tp) = pair
    cfg = tm.cfg
    ps, pps = 4, 8
    pages = _pages(cfg, 2 * pps, ps)
    jpages = jax.tree.map(jnp.asarray, pages)
    tpages = {pos: {n: torch.from_numpy(l.copy()) for n, l in e.items()}
              for pos, e in pages.items()}
    table = np.arange(2 * pps, dtype=np.int32).reshape(2, pps)
    jtab, ttab = jnp.asarray(table), torch.from_numpy(table)
    rng = np.random.default_rng(2)
    i32 = lambda v: np.asarray(v, np.int32)  # noqa: E731

    chunk = rng.integers(0, 500, size=(2, 8)).astype(np.int32)
    args = (i32([0, 0]), i32([8, 6]))
    jl, jpages = jm.prefill_chunk_step(jp, jnp.asarray(chunk), jpages, jtab,
                                       *map(jnp.asarray, args), page_size=ps)
    tl, tpages = tm.prefill_chunk_step(tp, torch.from_numpy(chunk), tpages, ttab,
                                       *map(torch.from_numpy, args), page_size=ps)
    _close(tl, jl)

    tok, lengths = rng.integers(0, 500, size=(2, 1)).astype(np.int32), i32([8, 6])
    jl, jpages = jm.decode_step_paged(jp, jnp.asarray(tok), jpages, jtab,
                                      jnp.asarray(lengths), page_size=ps)
    tl, tpages = tm.decode_step_paged(tp, torch.from_numpy(tok), tpages, ttab,
                                      torch.from_numpy(lengths), page_size=ps)
    _close(tl, jl)

    chunk = rng.integers(0, 500, size=(2, 4)).astype(np.int32)
    args = (i32([9, 7]), i32([4, 3]))
    jl, _ = jm.verify_chunk_step(jp, jnp.asarray(chunk), jpages, jtab,
                                 *map(jnp.asarray, args), page_size=ps)
    tl, _ = tm.verify_chunk_step(tp, torch.from_numpy(chunk), tpages, ttab,
                                 *map(torch.from_numpy, args), page_size=ps)
    assert tl.shape == (2, 4, cfg.padded_vocab_size)
    for b, n in enumerate(args[1]):
        _close(tl[b, :n], np.asarray(jl)[b, :n])
