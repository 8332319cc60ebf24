"""Launchers of the port (``python -m repro_torch.launch.train``); the
reference's dry-run, roofline and report tools are not ported yet
(ROADMAP M11)."""
