"""The plain float32 references the benchmark judges the port against.

Plain PyTorch only: nothing here imports the port, the JAX package or JAX.
Of what the port made it reads only what it judges: the logits, and an MoE
model's expert choices, which it follows and judges by themselves
(``lm.Routing``).  The models are written out from the
configuration's file (``ridgebench/configs/<name>.json``), with the
products done by an ``Arith``: float32 with TF32 off, or, for the control,
every product's inputs rounded to float8 (e4m3) first.
"""
