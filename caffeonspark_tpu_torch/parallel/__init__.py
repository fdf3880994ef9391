"""Parallelism of the PyTorch port (the counterpart of
`caffeonspark_tpu/parallel/`): device meshes (`mesh.py`) and the
sequence-parallel ring attention (`sp.py`)."""
