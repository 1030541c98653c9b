"""Entry points: the serve and train CLIs (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``).

The planner and dry-run CLIs of ``repro.launch`` come with the mesh (ROADMAP
Queue 1, item 12).
"""
