"""Alignment: the host aligners and the batched ksw2 kernel."""
