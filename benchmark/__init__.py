"""The benchmark of the PyTorch port: ``python3 benchmark/run.py --help``."""
