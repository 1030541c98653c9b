"""Entry points: the serve and train CLIs (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and the analytic parallelism planner
(``python -m repro_torch.launch.plan``; numpy only, it touches no device).

``mesh`` builds the ``DeviceMesh`` (and the dry-run's fake one); ``specs``
lays trees out on it; the multi-pod dry-run is ``python -m
repro_torch.launch.dryrun`` (fake DTensors over a fake process group).
"""
