"""Scenario-axis data parallelism over devices and processes: the batch
of scenarios is split over a list of torch devices (mesh.py), and the
sweep statistics are averaged over torch.distributed processes
(distributed.py)."""
