"""The benchmark of ``emba_tpu_torch`` on one NVIDIA GPU: cells named in
``BENCHMARK.json`` at the root of the checkout, each a configuration
(``configs/``) under a traffic mix (``traffic/``), measured by
``python -m benchmark.run`` and read by the metric readers of ``metrics/``."""
