from repro_torch.kernels.group_gate.ops import gate_logits, group_gate, group_gate_plain

__all__ = ["gate_logits", "group_gate", "group_gate_plain"]
