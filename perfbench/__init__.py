"""The benchmark of rpt_tpu_torch: see `run.py` and PERF.md."""
