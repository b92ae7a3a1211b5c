"""Parallel serving and compute (counterpart of ``tpu_engine/parallel/``):
the device meshes of one process (``mesh``), ring and Ulysses attention
(``ring``) and GPipe microbatching (``pipeline``)."""
