"""The benchmark of ``kevlar_tpu_torch``: one cell a run (``run.py``)."""
