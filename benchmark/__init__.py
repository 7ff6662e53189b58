"""The benchmark of ``ikpso_tpu_torch``: one cell a run (``run.py``)."""
