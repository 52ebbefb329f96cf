"""Workflow drivers (the mark-I trio pipeline lives in
kevlar_tpu_torch.workflow)."""
