"""Entry points: the serve CLI (``python -m repro_torch.launch.serve``).

The planner, dry-run and train CLIs of ``repro.launch`` come with the mesh
(ROADMAP Queue 1, item 12).
"""
