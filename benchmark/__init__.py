"""The benchmark of mcmh_localization_tpu_torch: ``python3
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout."""
