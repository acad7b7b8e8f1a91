"""Runnable examples, each the port of one of the reference's
``examples/*.py`` (``python -m repro_torch.examples.<name>``; on the CUDA
card by default, ``--device cpu`` on the CPU)."""
