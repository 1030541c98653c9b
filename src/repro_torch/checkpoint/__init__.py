"""Checkpointing (``checkpointer``) and the elastic restore onto a mesh
(``elastic``: shardings from logical specs, per-host data configs after a
resize)."""
