"""Launchers of the port: training (``python -m repro_torch.launch.train``)
and the one-card launch tools: the dry-run on ``meta`` tensors
(``dryrun``, with ``specs``' inputs), the H100 roofline (``roofline``),
its tables (``report``, ``fill_experiments``) and the card's peak
memory in bf16 and f32 (``memprobe``)."""
