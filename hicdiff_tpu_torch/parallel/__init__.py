"""Data parallelism across processes (port of hicdiff_tpu/parallel/)."""
