"""Checkpointing (``checkpointer``); the elastic restore onto a mesh
(``repro.checkpoint.elastic``) comes with the mesh (ROADMAP Queue 1 item 12)."""
