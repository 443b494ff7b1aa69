"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell
of ``BENCHMARK.json`` a run, ``python3 -m portbench.run --workload NAME
--seed N --seconds S --trace 0|1``, from the root of a checkout."""
