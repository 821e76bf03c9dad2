"""The benchmark of tpu_pathtracer_torch: `python -m portbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` (see README.md)."""
