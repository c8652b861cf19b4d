"""The port's probes, each run as ``python -m
masters_thesis_tpu_torch.scripts.<name>``; none does work at import."""
