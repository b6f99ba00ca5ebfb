"""The BASELINE.json configuration runs:

    python -m zigbpe_tpu_torch.scripts.run_config2 [MB] [MERGES] [--device cuda]
    python -m zigbpe_tpu_torch.scripts.run_config3 [MB] [--device cuda]

Ports of ``scripts/run_config2.py`` and ``scripts/run_config3.py``. Each
prints one JSON line with the JAX script's keys and ``device``, and writes it
to ``results/<name>.json`` in the checkout (a directory that ``.gitignore``
lists); the JAX runs' records (``CONFIG*_r*.json``) are never written.

On the CPU the plain twins run, for checking: every field that times the
card is null there, and ``device`` reads ``cpu``.
"""
