"""The benchmark of mesheditor_tpu_torch on one NVIDIA H100: `python3 -m portbench
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`. See README.md."""
