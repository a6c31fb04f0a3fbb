"""The benchmark of ``sequoia_tpu_torch`` on the H100: ``python -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the checkout's root.  Cells, configurations, traffic mixes, entries,
limits and per-layer metrics are files found by the names in
``BENCHMARK.json``."""
