"""The benchmark of the PyTorch port: `python3 -m bench_port.run` (see run.py)."""
