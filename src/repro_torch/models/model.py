"""Model facade (port of the reference's ``models/model.py``: ``init``,
``train_logits``, ``prefill`` and ``decode_step`` over dense rings, and
``decode_step_paged``, ``prefill_chunk_step``, ``verify_chunk_step`` over
paged pools, each on the model's topology: one device, or one rank of an
expert-parallel mesh whose MoE layers run the ``a2a`` / ``tp`` bodies)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import init_expert_slices
from repro_torch.distributed.topology import Topology, single_device_topology
from repro_torch.models import attention as attn
from repro_torch.models import ssm, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device = torch.device(DEFAULT_DEVICE)
    topo: Topology = field(default_factory=single_device_topology)

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    def init(self, generator: torch.Generator, *, expert_seed: Optional[int] = None) -> Dict:
        """Random params (the reference's shapes and init scales) drawn from
        ``generator``, placed on the model's device.

        With ``expert_seed`` the MoE layers' expert weights are drawn apart,
        each expert's from a generator seeded by ``expert_seed``, its layer
        and its index (``core.moe.init_expert_slices``), and only this
        rank's experts (``Topology.expert_slice``): every rank of an
        expert-parallel mesh draws the same non-expert params from
        ``generator`` and its own experts alone, and a one-device model
        drawn with the same seeds holds the same weights.  Where weights are
        resident on a mesh (``serve_*``) an SSM layer keeps only this rank's
        head slices (``ssm.resident_slices``), as the bridge hands them out."""
        if expert_seed is None:
            return self._resident(transformer.init_params(self.cfg, generator))
        params = transformer.init_params(self.cfg, generator, draw_experts=False)
        R, n_pos = self.cfg.block_repeat, len(self.cfg.layer_pattern)
        for i, spec in enumerate(self.cfg.layer_pattern):
            if spec.moe and self.cfg.moe is not None:
                layers = [r * n_pos + i for r in range(R)]
                params["blocks"][f"pos{i}"]["moe"].update(init_expert_slices(
                    self.cfg, expert_seed, layers, self.topo, generator.device))
        return self._resident(params)

    def _resident(self, params: Dict) -> Dict:
        for layer in params["blocks"].values():
            if "ssm" in layer:
                layer["ssm"] = {k: v.contiguous()
                                for k, v in ssm.resident_slices(layer["ssm"], self.topo).items()}
        return to_device(params, self.device)

    def _angles(self, positions: torch.Tensor) -> torch.Tensor:
        """Angles at positions [B, S], or [B, 3, S] under M-RoPE (a text
        token's [B, S] position goes on all three axes)."""
        return attn.model_angles(self.cfg, positions)

    def _embed(self, params, batch: Dict):
        """(the embedded inputs [B, S, d] with any patch embeddings in
        front, their rotary angles at ``batch["positions"]`` or 0..S-1)."""
        tokens = batch["tokens"]
        x = transformer.embed_inputs(params, self.cfg, tokens, batch.get("patch_embeds"))
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
        return x, self._angles(positions)

    def _encoder_out(self, params, batch: Dict):
        """The encoder's output over ``batch["frame_embeds"]`` (None unless
        the model is an encoder-decoder)."""
        if not self.cfg.encoder_decoder:
            return None
        return transformer.apply_encoder(params, batch["frame_embeds"], self.cfg)

    def train_logits(self, params, batch: Dict, *, expert_mask=None,
                     train: bool = True) -> Tuple[torch.Tensor, Dict]:
        """The full-sequence forward of training -> (logits [B, S, V], aux):
        ``batch`` as :meth:`prefill` takes it; the aux summed over the MoE
        layers (``transformer.apply_stack_full(train=True)``: router
        losses, ``aux_loss`` and the routing statistics).  ``train=True``
        recomputes each block in the backward (the reference's ``remat and
        train``); ``train=False`` runs the same forward without
        recomputation.  On a mesh the batch is this rank's shard and the
        params the forms the train step computes on (non-expert leaves
        whole, this rank's experts); the logits are this rank's batch shard
        of its vocabulary slice when the mesh has a model axis
        (``transformer.lm_logits``), as the vocabulary-sharded loss takes
        them."""
        cfg = self.cfg
        x, angles = self._embed(params, batch)
        x, aux, _ = transformer.apply_stack_full(
            params, x, cfg, angles, causal=True, enc_out=self._encoder_out(params, batch),
            expert_mask=expert_mask, train=True, remat=train, topo=self.topo,
        )
        return transformer.lm_logits(params, cfg, x, self.topo), aux

    def prefill(self, params, batch: Dict, *, max_len: int = 0,
                expert_mask=None) -> Tuple[torch.Tensor, Dict]:
        """A full prompt -> (logits of the last position [B, V], dense cache
        of ``kvcache.init_cache``'s layout with rings of ``max_len`` (S by
        default), cross caches or SSM states and conv tails, and ``lengths``
        S).  ``batch``: ``tokens`` [B, T]; for a VLM optionally
        ``patch_embeds`` [B, P, d], which go in front of the tokens (S = P +
        T), and ``positions`` ([B, S], or [B, 3, S] under M-RoPE; 0..S-1 on
        every axis by default); for an encoder-decoder ``frame_embeds``
        [B, S_enc, d] in the activation type, the precomputed audio frames
        that the encoder reads and every decoder layer's cross-attention
        attends (their projections are the cache's ``xk``/``xv``)."""
        cfg = self.cfg
        x, angles = self._embed(params, batch)
        B, S = x.shape[:2]
        x, _, blocks = transformer.apply_stack_full(
            params, x, cfg, angles, causal=True,
            enc_out=self._encoder_out(params, batch), expert_mask=expert_mask,
            collect_cache=True, max_len=max_len or S, topo=self.topo,
        )
        logits = transformer.lm_logits(params, cfg, x[:, -1:])[:, 0]
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, {"blocks": blocks, "lengths": lengths}

    def decode_step(self, params, tokens: torch.Tensor, cache: Dict, *,
                    expert_mask=None) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, 1] against a dense cache -> (logits [B, V], the cache
        with its rings and SSM states written in place and ``lengths``
        advanced)."""
        cfg = self.cfg
        lengths = cache["lengths"]
        x = transformer.embed_inputs(params, cfg, tokens)
        x, blocks, _ = transformer.apply_stack_decode(
            params, x, cfg, self._angles(lengths[:, None]), cache["blocks"], lengths,
            expert_mask, topo=self.topo,
        )
        logits = transformer.lm_logits(params, cfg, x)[:, 0]
        return logits, {"blocks": blocks, "lengths": lengths + 1}

    def decode_step_paged(
        self, params, tokens: torch.Tensor, page_blocks: Dict,
        page_table: torch.Tensor, lengths: torch.Tensor, *,
        page_size: int, expert_mask=None,
    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, 1] against the paged KV cache -> (logits [B, V], page
        blocks, written in place).  ``lengths`` [B] int32 is each slot's
        position of the new token (the engine owns slot offsets)."""
        cfg = self.cfg
        angles = self._angles(lengths[:, None])
        x = transformer.embed_inputs(params, cfg, tokens)
        x, page_blocks, _ = transformer.apply_stack_decode(
            params, x, cfg, angles, page_blocks, lengths, expert_mask,
            page_table=page_table, page_size=page_size, topo=self.topo,
        )
        return transformer.lm_logits(params, cfg, x)[:, 0], page_blocks

    def prefill_chunk_step(
        self, params, tokens: torch.Tensor, page_blocks: Dict,
        page_table: torch.Tensor, start: torch.Tensor, n_valid: torch.Tensor, *,
        page_size: int, expert_mask=None,
    ) -> Tuple[torch.Tensor, Dict]:
        """One fixed-size prompt chunk (tokens [B, C], rows past ``n_valid``
        are padding) written at positions ``start + i`` -> (logits of the
        last valid row [B, V], page blocks)."""
        cfg = self.cfg
        B, C = tokens.shape
        positions = start[:, None] + torch.arange(C, dtype=torch.int32, device=tokens.device)[None, :]
        angles = self._angles(positions)
        x = transformer.embed_inputs(params, cfg, tokens)
        x, page_blocks = transformer.apply_stack_prefill_chunk(
            params, x, cfg, angles, page_blocks, page_table, positions, n_valid,
            page_size, expert_mask=expert_mask, topo=self.topo,
        )
        last = (n_valid.long() - 1).clamp_min(0)
        x_last = x[torch.arange(B, device=x.device), last][:, None]
        return transformer.lm_logits(params, cfg, x_last)[:, 0], page_blocks


    def verify_chunk_step(
        self, params, tokens: torch.Tensor, page_blocks: Dict,
        page_table: torch.Tensor, start: torch.Tensor, n_valid: torch.Tensor, *,
        page_size: int, expert_mask=None,
    ) -> Tuple[torch.Tensor, Dict]:
        """Speculative verify: :meth:`prefill_chunk_step`'s forward, with
        the logits of every position [B, C, V] (row i predicts the token at
        ``start + i + 1``; rows past ``n_valid`` are padding)."""
        cfg = self.cfg
        C = tokens.shape[1]
        positions = start[:, None] + torch.arange(C, dtype=torch.int32, device=tokens.device)[None, :]
        x = transformer.embed_inputs(params, cfg, tokens)
        x, page_blocks = transformer.apply_stack_prefill_chunk(
            params, x, cfg, self._angles(positions), page_blocks, page_table, positions,
            n_valid, page_size, expert_mask=expert_mask, topo=self.topo,
        )
        return transformer.lm_logits(params, cfg, x), page_blocks


def build_model(cfg: ModelConfig, topo: Optional[Topology] = None,
                device=DEFAULT_DEVICE) -> Model:
    return Model(cfg, device, topo or single_device_topology())


def to_device(tree: Dict, device) -> Dict:
    """A nested dict of tensors (params, page blocks) moved to ``device``."""
    return {
        k: to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }


def leaves(tree: Dict) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, depth first."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v
