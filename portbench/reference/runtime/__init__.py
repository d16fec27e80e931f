"""Closed-loop orchestration and batched scenario sweeps."""
