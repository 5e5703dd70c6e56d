"""The benchmark of the PyTorch/CUDA port (`adapm_tpu_torch`): one cell a
run, `python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`. Cells, configurations, traffic mixes, metric readers,
kernel costs, limits and the plain reference live in files of their own
here and are found by the names in `BENCHMARK.json`."""
