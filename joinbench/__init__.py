"""The benchmark of the PyTorch/CUDA port (``avx_sort_merge_joins_tpu_torch``):
one cell a run, its relations made from the seed, a closed loop of joins
over a fixed window, every answer checked against a plain reference.
Run from the checkout's root: ``python3 -m joinbench --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``."""
