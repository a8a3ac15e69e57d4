"""End-cloud collaborative inference, one-shot (port of the reference's
``serving/endcloud.py``: the tier planner and ``EndCloudPipeline``).

The model's ``block_repeat`` blocks are split at ``split`` (chosen by the
route-aware planner, eq. 9-11): blocks [0, split) run on the "end" tier
with the hardware-aware expert mask (eq. 2-4) on every MoE layer; the
boundary activation is low-rank compressed (eq. 8), metered against the
modeled link, decompressed, and blocks [split, R) plus the LM head run on
the "cloud" tier with the full expert set.  Both tiers run in this process
on one device, through separate parameter subtrees, so the same code
drives a two-host deployment by placing each tier's params on its own host.

``EndCloudPipeline.run_batch`` is the paper's fig. 5-6 measurement mode:
full-sequence (prefill-style) batches.  Its tier times are taken with the
device synchronized around each tier; the link time is modeled from the
planner's link rate (``LinkStats``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core.hardware import Capability, DeviceProfile, DeviceState, capability
from repro_torch.core.pipeline import PipelinePlan, plan_pipeline_split
from repro_torch.core.selection import end_mask_for, validate_expert_mask
from repro_torch.models import attention as attn
from repro_torch.models import kvcache, transformer
from repro_torch.models.model import Model
from repro_torch.serving.common import LinkStats

__all__ = [
    "EndCloudPipeline",
    "LinkStats",
    "TierPlan",
    "block_gflops",
    "end_mask_from_state",
    "init_tier_pages",
    "plan_tiers",
    "split_block_params",
    "strip_expert_weights",
]

CODEC_SEED = 7  # the reference draws its codec from jax.random.PRNGKey(7)


def end_mask_from_state(
    cfg,
    end_profile: DeviceProfile,
    end_state: DeviceState,
    *,
    selection_eps: float = 1.0,
    group_priority=None,
) -> Optional[np.ndarray]:
    """Hardware-aware local expert mask (eq. 2-4) for the end tier, a bool
    ``[E]`` numpy array; None for dense models."""
    if cfg.moe is None:
        return None
    return end_mask_for(
        end_profile,
        end_state,
        cfg.d_model,
        cfg.moe.d_ff_expert,
        cfg.moe.num_experts,
        cfg.moe.num_groups,
        gated=cfg.ffn_gated,
        eps=selection_eps,
        selection_cap=cfg.moe.local_selection_cap,
        group_priority=group_priority,
    )


def split_block_params(params: Dict, split: int) -> Tuple[Dict, Dict]:
    """Split stacked block params [R, ...] into ([0,split), [split,R))
    (views, no copy).  The end tier owns the embedding (it sees raw
    tokens); the cloud tier owns everything else, including the final norm
    and LM head."""

    def cut(tree, sl):
        return {k: cut(v, sl) if isinstance(v, dict) else v[sl] for k, v in tree.items()}

    end = {"embed": params["embed"], "blocks": cut(params["blocks"], slice(None, split))}
    cloud = {k: v for k, v in params.items() if k != "blocks"}
    cloud["blocks"] = cut(params["blocks"], slice(split, None))
    return end, cloud


def strip_expert_weights(tier_params: Dict, cfg) -> Dict:
    """Pooled end tier: drop the dense per-expert weight stacks
    (``wi``/``wg``/``wo``, ``[n_blocks, E, ...]``) from a tier's block
    params; the resident experts live in the slab store
    (``core.expertpool``) instead.  Gate and shared-expert params stay."""
    blocks = {}
    for i, spec in enumerate(cfg.layer_pattern):
        layer = tier_params["blocks"][f"pos{i}"]
        if spec.moe and "moe" in layer:
            layer = {**layer, "moe": {k: v for k, v in layer["moe"].items()
                                      if k not in ("wi", "wg", "wo")}}
        blocks[f"pos{i}"] = layer
    return {**tier_params, "blocks": blocks}


def init_tier_pages(cfg, split: int, end_pages: int, cloud_pages: int,
                    page_size: int, dtype: torch.dtype, device, *,
                    quantized: bool = False) -> Tuple[Dict, Dict]:
    """Paged KV storage for the two tiers of a block split: the end pool
    backs blocks ``[0, split)``, the cloud pool ``[split, R)``; a replan
    moves block rows between them (``kvcache.resplit_paged_blocks``), int8
    codes and their scales alike (``quantized=True``)."""
    end = kvcache.init_paged_blocks(cfg, split, end_pages, page_size, dtype, device,
                                    quantized=quantized)
    cloud = kvcache.init_paged_blocks(
        cfg, cfg.block_repeat - split, cloud_pages, page_size, dtype, device,
        quantized=quantized,
    )
    return end, cloud


def block_gflops(cfg) -> float:
    """Forward GFLOP per token per *block* — one repeat of the full layer
    pattern, the unit the split search slices at (embedding/head excluded)."""
    n = cfg.active_param_count() - 2 * cfg.vocab_size * cfg.d_model
    per_block = max(n, 1) / max(cfg.block_repeat, 1)
    return 2.0 * per_block * 1e-9


@dataclass
class TierPlan:
    """Everything the split needs beyond raw params: capabilities (eq. 3),
    the end tier's expert mask (eq. 2-4, a bool tensor on the model's
    device), the boundary codec (eq. 8), and the route-aware pipeline plan
    (eq. 9-11) with the planning inputs it was computed from."""

    end_cap: Capability
    cloud_cap: Capability
    end_mask: Optional[torch.Tensor]
    codec: Optional[Dict]
    plan: PipelinePlan
    alpha: float
    layer_gflops: Tuple[float, ...] = ()
    boundary_bytes: float = 0.0
    compression_ratio: float = 1.0

    @property
    def split(self) -> int:
        return self.plan.split_layer

    @property
    def compress(self) -> bool:
        return self.codec is not None and self.plan.compress_boundary


_DERIVE_MASK = object()  # sentinel: "derive the end mask from the state"


def plan_tiers(
    model: Model,
    *,
    end_profile: DeviceProfile,
    cloud_profile: DeviceProfile,
    end_state: Optional[DeviceState] = None,
    end_mask=_DERIVE_MASK,
    codec_params: Optional[Dict] = None,
    compression_rank: int = 0,
    alpha: float = 0.5,
    selection_eps: float = 1.0,
    force_split: Optional[int] = None,
    cloud_share: float = 1.0,
) -> TierPlan:
    """The shared tier context of the end-cloud executors.

    ``force_split`` pins the split point (parity tests and ablations).
    ``end_mask`` overrides the eq. 2-4 derivation.  ``cloud_share`` scales
    the cloud capability to this device's share of a fleet-shared cloud
    tier.  Without ``codec_params``, a rank > 0 draws an orthonormal codec
    from a CPU generator seeded with ``CODEC_SEED``."""
    cfg = model.cfg
    end_state = end_state or DeviceState()
    end_cap = capability(end_profile, end_state)
    cloud_cap = capability(cloud_profile, DeviceState())
    if cloud_share != 1.0:
        cloud_cap = replace(
            cloud_cap, gflop_budget=cloud_cap.gflop_budget * cloud_share
        )

    if end_mask is _DERIVE_MASK:
        end_mask = end_mask_from_state(
            cfg, end_profile, end_state, selection_eps=selection_eps
        )
    # an all-False mask would make the gate renormalize to uniform weights
    # over the very experts it excluded
    validate_expert_mask(
        end_mask,
        cfg.moe.num_experts if cfg.moe is not None else None,
        where="plan_tiers(end_mask)",
    )
    if end_mask is not None:
        end_mask = torch.as_tensor(np.asarray(end_mask, bool), device=model.device)

    # Codec (eq. 8).
    codec = codec_params
    if codec is None and compression_rank > 0:
        codec = comp.init_lowrank_1d(
            torch.Generator().manual_seed(CODEC_SEED), cfg.d_model,
            compression_rank, device=model.device,
        )
    if codec is not None:  # the products' copy in the activation type, cast once
        codec = comp.compute_codec(codec, cfg.torch_dtype)
    rank = codec["enc"].shape[1] if codec is not None else 0

    # Route-aware split (eq. 9-11 pipeline reading).  The embedding stays on
    # the end and the LM head on the cloud, so an activation crosses the
    # wire at every split (edge_boundary).
    boundary_bytes = float(cfg.d_model * 2)  # per token, bf16
    ratio = comp.compression_ratio(cfg.d_model, rank) if codec is not None else 1.0
    layer_gflops = (block_gflops(cfg),) * cfg.block_repeat
    plan = plan_pipeline_split(
        layer_gflops,
        boundary_bytes,
        end_cap,
        cloud_cap,
        compression_ratio=ratio,
        alpha=alpha,
        edge_boundary=True,
        pin_split=force_split,
    )
    return TierPlan(
        end_cap, cloud_cap, end_mask, codec, plan, alpha,
        layer_gflops=layer_gflops,
        boundary_bytes=boundary_bytes,
        compression_ratio=ratio,
    )


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the CPU runs eagerly)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EndCloudPipeline:
    """Runs full-sequence (prefill-style) inference across two tiers."""

    def __init__(
        self,
        model: Model,
        params: Dict,
        *,
        end_profile: DeviceProfile,
        cloud_profile: DeviceProfile,
        end_state: Optional[DeviceState] = None,
        codec_params: Optional[Dict] = None,  # 1-D low-rank codec {"enc","dec"}
        compression_rank: int = 0,
        alpha: float = 0.5,
        selection_eps: float = 1.0,
    ):
        cfg = model.cfg
        if any(spec.cross_attn for spec in cfg.layer_pattern):
            raise NotImplementedError(
                f"{cfg.name}: cross-attention (encoder-decoder) patterns are not served: "
                "the reference EndCloudPipeline runs its layers with no encoder output "
                "(enc_out), so its cross-attention has nothing to attend; run "
                "Model.prefill / decode_step"
            )
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.end_profile = end_profile
        self.cloud_profile = cloud_profile
        self.end_state = end_state or DeviceState()
        self.link = LinkStats()
        self.tiers = plan_tiers(
            model,
            end_profile=end_profile,
            cloud_profile=cloud_profile,
            end_state=self.end_state,
            codec_params=codec_params,
            compression_rank=compression_rank,
            alpha=alpha,
            selection_eps=selection_eps,
        )
        # weights every use casts to the activation type are stored in it
        # once (the values the forward sees are the same)
        self.params = transformer.compute_params(params, cfg)
        self.end_params, self.cloud_params = split_block_params(self.params, self.split)

    # -- everything the split derives delegates to self.tiers ---------------

    @property
    def end_cap(self) -> Capability:
        return self.tiers.end_cap

    @property
    def cloud_cap(self) -> Capability:
        return self.tiers.cloud_cap

    @property
    def end_mask(self) -> Optional[torch.Tensor]:
        return self.tiers.end_mask

    @property
    def codec(self) -> Optional[Dict]:
        return self.tiers.codec

    @property
    def plan(self) -> PipelinePlan:
        return self.tiers.plan

    @property
    def split(self) -> int:
        return self.tiers.plan.split_layer

    # -- tier forwards --------------------------------------------------------

    def _angles(self, B: int, S: int) -> torch.Tensor:
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        return attn.model_angles(self.cfg, pos)

    def _blocks(self, tier_params: Dict, n_blocks: int, x: torch.Tensor,
                expert_mask) -> torch.Tensor:
        cfg = self.cfg
        angles = self._angles(*x.shape[:2])
        for r in range(n_blocks):
            bp = transformer.block_params(tier_params["blocks"], r)
            for i, spec in enumerate(cfg.layer_pattern):
                x, _, _ = transformer.apply_layer_full(
                    bp[f"pos{i}"], x, spec, cfg, angles, causal=True,
                    expert_mask=expert_mask,
                )
        return x

    def _end_forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = transformer.embed_inputs(self.end_params, self.cfg, tokens)
        x = self._blocks(self.end_params, self.split, x, self.end_mask)
        if self.tiers.compress:
            x = comp.encode_1d(self.codec, x)
        return x

    def _cloud_forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = comp.decode_1d(self.codec, z) if self.tiers.compress else z
        x = x.to(cfg.torch_dtype)
        x = self._blocks(self.cloud_params, cfg.block_repeat - self.split, x, None)
        return transformer.lm_logits(self.cloud_params, cfg, x)

    # -- public ---------------------------------------------------------------

    def run_batch(self, tokens) -> Tuple[torch.Tensor, Dict[str, float]]:
        """tokens [B, S] -> (logits [B, S, V], timing/bytes metrics).  Tier
        times are host-clock seconds around each tier with the device
        synchronized before and after; ``t_comm_s`` is the modeled wire
        time of the boundary payload."""
        tokens = torch.as_tensor(tokens, device=self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        z = self._end_forward(tokens)
        _sync(self.device)
        t_end = time.perf_counter() - t0

        nbytes = z.numel() * z.element_size()
        t_comm = self.link.record_up(nbytes, self.end_cap.net_gbps)

        t1 = time.perf_counter()
        logits = self._cloud_forward(z)
        _sync(self.device)
        t_cloud = time.perf_counter() - t1
        return logits, {
            "t_end_s": t_end,
            "t_comm_s": t_comm,
            "t_cloud_s": t_cloud,
            "boundary_bytes": nbytes,
            "split": self.split,
            "compressed": self.tiers.compress,
        }
