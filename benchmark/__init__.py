"""The benchmark of vpic_tpu_torch on one CUDA card: ``python
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(see run.py and core.py)."""
