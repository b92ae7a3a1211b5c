"""Parallel serving (counterpart of ``tpu_engine/parallel/``): the
tensor-parallel group of one process (``mesh``)."""
