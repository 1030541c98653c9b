"""Entry points: the serve and train CLIs (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and the analytic parallelism planner
(``python -m repro_torch.launch.plan``; numpy only, it touches no device).

The dry-run CLI of ``repro.launch`` comes with the mesh (ROADMAP Queue 1,
item 12).
"""
