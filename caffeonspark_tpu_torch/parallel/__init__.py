"""Parallelism of the PyTorch port (the counterpart of
`caffeonspark_tpu/parallel/`); so far only the single-device attention
reference of `sp.py`."""
